"""nanopolish_tpu_torch stands alone: it imports neither jax nor any
module of nanopolish_tpu, runs on the GPU unless asked for the CPU (no
silent fallback), carries its own copy of the pore models, and takes a
JAX PoreModel over through plain arrays."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nanopolish_tpu
import nanopolish_tpu_torch
from nanopolish_tpu.models.pore_model import PoreModelSet as JaxModels
from nanopolish_tpu_torch.models.pore_model import pore_model_from_numpy
from nanopolish_tpu_torch.utils.device import DeviceUnavailable, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import nanopolish_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "nanopolish_tpu" or m.startswith("nanopolish_tpu."))
print(len(names), ",".join(leaked))
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, leaked = r.stdout.strip().split(" ", 1) if " " in r.stdout.strip() \
        else (r.stdout.strip(), "")
    assert int(n) >= 25
    assert leaked == ""


def test_sources_name_no_jax_package():
    pkg_dir = os.path.dirname(nanopolish_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "from nanopolish_tpu ",
                            "from nanopolish_tpu.", "import nanopolish_tpu\n",
                            "import nanopolish_tpu."):
                    assert bad not in src, (f, bad)


def test_eventalign_without_cuda_exits_with_reason():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "eventalign", "-r", "x.fastq", "-b", "x.bam",
                        "-g", "x.fa"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    with pytest.raises(DeviceUnavailable):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("argv", [
    ["call-methylation", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa"],
    ["scorereads", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa"],
    ["phase-reads", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa", "x.vcf"],
    ["variants", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa", "-w",
     "tig1:0-100", "--consensus"]])
def test_forward_subcommands_without_cuda_exit_with_reason(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr


def _library_calls():
    from nanopolish_tpu_torch.alignment.segments import (ScoreBatcher,
                                                         forward_arrays,
                                                         forward_segments,
                                                         viterbi_segments)
    from nanopolish_tpu_torch.models.read_builder import build_reads
    from nanopolish_tpu_torch.ops import banded_align as ba
    from nanopolish_tpu_torch.ops import banded_exact as bx
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    ev = np.full((1, 8), 90.0, np.float32)
    mu = np.full((1, 4), 90.0, np.float32)
    sd = np.ones((1, 4), np.float32)
    nev, nk = np.array([8], np.int32), np.array([4], np.int32)
    banded = (ev, nev, mu, sd, np.log(sd), nk)
    viterbi = (ev, nev, mu, sd, nk, np.array([2.0], np.float32), 0)
    return {
        "prepare_banded_inputs": lambda **kw: ba.prepare_banded_inputs(
            *banded, **kw),
        "banded_align_batch": lambda **kw: ba.banded_align_batch(
            *banded, **kw),
        "banded_align_exact": lambda **kw: bx.banded_align_exact(
            *banded, **kw),
        "prepare_viterbi_inputs": lambda **kw: pv.prepare_viterbi_inputs(
            *viterbi, **kw),
        "profile_hmm_viterbi_align": lambda **kw: pv.profile_hmm_viterbi_align(
            *viterbi, **kw),
        "viterbi_segments": lambda **kw: viterbi_segments([], **kw),
        "prepare_forward_inputs": lambda **kw: pf.prepare_forward_inputs(
            *viterbi, **kw),
        "profile_hmm_forward": lambda **kw: pf.profile_hmm_forward(
            *viterbi, **kw),
        "forward_segments": lambda **kw: forward_segments([], **kw),
        "forward_arrays": lambda **kw: forward_arrays(
            ev, nev, mu, sd, nk, np.array([2.0], np.float32),
            np.zeros(1, np.int32), **kw),
        "build_reads": lambda **kw: build_reads([], **kw),
        "forward_indexed_scores": lambda **kw: pi.forward_indexed_scores(
            ev, nev, np.stack([mu, sd, sd]), np.arange(4, dtype=np.int32)[None],
            nk,
            np.zeros((1, 8), np.float32), np.zeros((1, 4), np.int32), 3,
            **kw),
        "ScoreBatcher": lambda **kw: ScoreBatcher(**kw),
    }


@pytest.mark.parametrize("name", sorted(_library_calls()))
def test_library_entry_points_default_to_cuda(name):
    """A caller who names no device gets cuda, or an error saying why;
    never a silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = _library_calls()[name]
    with pytest.raises(DeviceUnavailable, match="device='cpu'"):
        call()
    call(device="cpu")


def test_unported_subcommands_exit_2():
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch",
                        "polya"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 2
    assert "not yet ported to nanopolish_tpu_torch" in r.stderr


def test_builtin_models_are_the_jax_packages():
    a = np.load(os.path.join(os.path.dirname(nanopolish_tpu.__file__),
                             "data", "builtin_models.npz"))
    b = np.load(os.path.join(os.path.dirname(nanopolish_tpu_torch.__file__),
                             "data", "builtin_models.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("key", [
    ("r9.4_450bps", "nucleotide", "template", 6),
    ("r9.4_450bps", "cpg", "template", 6),
    ("r9.4_70bps", "u_to_t_rna", "template", 5),
])
def test_pore_model_from_numpy_round_trips(key):
    jm = JaxModels.instance().get_model(*key)
    arrays = dict(kit=jm.kit, strand=jm.strand, k=jm.k,
                  alphabet=jm.alphabet.name, level_mean=jm.level_mean,
                  level_stdv=jm.level_stdv, sd_mean=jm.sd_mean,
                  sd_stdv=jm.sd_stdv, name=jm.name,
                  model_filename=jm.model_filename)
    tm = pore_model_from_numpy(arrays)
    assert tm.key() == jm.key() and tm.name == jm.name
    for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv",
              "level_log_stdv", "sd_lambda", "sd_log_lambda"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    own = PoreModelSet.instance().get_model(*key)
    np.testing.assert_array_equal(own.level_mean, tm.level_mean)
