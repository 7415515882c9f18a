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
    assert int(n) >= 50
    assert leaked == ""


@pytest.mark.parametrize("name", [
    "nanopolish_tpu_torch.parallel", "nanopolish_tpu_torch.parallel.mesh",
    "nanopolish_tpu_torch.parallel.distributed",
    "nanopolish_tpu_torch.parallel.launch",
    "nanopolish_tpu_torch.parallel.train_step",
    "nanopolish_tpu_torch.ops.training",
    "nanopolish_tpu_torch.io.fast5_legacy",
    "nanopolish_tpu_torch.ops.profile_hmm_r7",
    "nanopolish_tpu_torch.utils.logsum",
    "nanopolish_tpu_torch.apps.call_methylation",
    "nanopolish_tpu_torch.alignment.device_chain",
    "nanopolish_tpu_torch.ops.chain_step",
    "nanopolish_tpu_torch.ops.ingest_fused"])
def test_parallel_modules_are_in_the_no_jax_import_check(name):
    """The multi-process modules, the legacy R7 modules, the watch
    mode's app, the device chain's modules and the ingest's are among
    those the jax-blocked probe above imports."""
    import pkgutil
    pkg = nanopolish_tpu_torch
    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    assert name in walked


_R7_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["h5py"] = None           # the card machine lists no h5py
from nanopolish_tpu_torch.io import fast5_legacy
from nanopolish_tpu_torch.ops import profile_hmm_r7
from nanopolish_tpu_torch.utils.logsum import add_logs_np
try:
    fast5_legacy.load_legacy_2d("x.fast5")
except ImportError:
    print("lazy")
"""


def test_legacy_modules_import_without_h5py():
    """fast5_legacy imports h5py only inside its loader, so nothing on
    the card's path needs it."""
    r = subprocess.run([sys.executable, "-c", _R7_PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "lazy"


def _subcommands():
    from nanopolish_tpu import __main__ as jax_main
    return list(jax_main.SUBCOMMANDS)


@pytest.mark.parametrize("name", _subcommands())
def test_each_subcommand_takes_the_jax_apps_flags(name):
    """Each app's parser takes exactly the JAX app's flags, plus
    --device where it runs on the card."""
    import importlib
    mod = name.replace("-", "_")
    jax_app = importlib.import_module(f"nanopolish_tpu.apps.{mod}")
    port_app = importlib.import_module(f"nanopolish_tpu_torch.apps.{mod}")

    def flags(app):
        return {s for a in app.make_parser()._actions
                for s in a.option_strings}

    extra = flags(port_app) - flags(jax_app)
    assert flags(jax_app) <= flags(port_app)
    assert extra <= {"--device"}


def test_launch_spawns_the_port(tmp_path):
    """parallel.launch runs ``python -m nanopolish_tpu_torch``, not the
    JAX package, in every child."""
    from nanopolish_tpu_torch.parallel import launch
    assert launch.child_argv(["eventalign"])[1:] == [
        "-m", "nanopolish_tpu_torch", "eventalign"]
    pattern = str(tmp_path / "v.{i}.txt")
    assert launch.main(["-n", "2", "--stdout", pattern, "--",
                        "--version"]) == 0
    for i in range(2):
        text = open(pattern.replace("{i}", str(i))).read()
        assert text.startswith("nanopolish_tpu_torch "), text


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
     "tig1:0-100", "--consensus"],
    ["polya", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa"],
    ["detect-polyi", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa"],
    ["methyltrain", "-r", "x.fastq", "-b", "x.bam", "-g", "x.fa", "-m",
     "x.fofn"],
    ["train-poremodel-from-basecalls", "-r", "x.fastq"]])
def test_forward_subcommands_without_cuda_exit_with_reason(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr


def _library_calls():
    from nanopolish_tpu_torch.apps import scorereads as sc
    from nanopolish_tpu_torch.apps import train_poremodel_from_basecalls as tp
    from nanopolish_tpu_torch.models.pore_model import PoreModelSet
    from nanopolish_tpu_torch.ops import mixture_em as em
    from nanopolish_tpu_torch.alignment.segments import (ScoreBatcher,
                                                         forward_arrays,
                                                         forward_segments,
                                                         viterbi_segments)
    from nanopolish_tpu_torch.alignment.device_chain import run_device_chain
    from nanopolish_tpu_torch.models.read_builder import build_reads
    from nanopolish_tpu_torch.ops.ingest_fused import \
        ingest_align_recalibrate_async
    from nanopolish_tpu_torch.ops import banded_align as ba
    from nanopolish_tpu_torch.ops import banded_exact as bx
    from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
    from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    from nanopolish_tpu_torch.ops import segmentation_hmm as sh
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
    from nanopolish_tpu_torch.parallel import Mesh, make_train_step
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
        "ingest_align_recalibrate_async":
            lambda **kw: ingest_align_recalibrate_async(
                ev, ev, nev, mu, sd, np.zeros((1, 4), np.int32), nk, **kw)(),
        "run_device_chain": lambda **kw: run_device_chain([], **kw),
        "forward_indexed_scores": lambda **kw: pi.forward_indexed_scores(
            ev, nev, np.stack([mu, sd, sd]), np.arange(4, dtype=np.int32)[None],
            nk,
            np.zeros((1, 8), np.float32), np.zeros((1, 4), np.int32), 3,
            **kw),
        "ScoreBatcher": lambda **kw: ScoreBatcher(**kw),
        "make_train_step": lambda **kw: make_train_step(Mesh(1, 1, 0), 4096,
                                                        **kw),
        "segment_reads": lambda **kw: sh.segment_reads(
            [ev[0]], [(1.0, 0.0, 1.0)], **kw),
        "seg_viterbi_fill": lambda **kw: sv.seg_viterbi_fill(
            *_seg_tensors(**kw)),
        "seg_backtrack": lambda **kw: sv.seg_backtrack(
            torch.zeros((8, 1), dtype=torch.uint8,
                        device=resolve_device(kw.get("device"))),
            _seg_tensors(**kw)[1]),
        "read_model_score": lambda **kw: sc.read_model_scores([], **kw),
        "train_gaussian_mixture_batched":
            lambda **kw: em.train_gaussian_mixture_batched(
                ev, ev, ev > 0, np.zeros((1, 2), np.float32),
                np.ones((1, 2), np.float32), np.ones((1, 2), np.float32),
                **kw),
        "train_invgaussian_mixture_batched":
            lambda **kw: em.train_invgaussian_mixture_batched(
                ev, ev, ev, ev, ev > 0, *([np.ones((1, 2), np.float32)] * 5),
                **kw),
        "train_poremodel_banded_align_exact":
            lambda **kw: tp._align_and_collect(
                [("q", "ACGTACGTAGGT", _Events(np.full(12, 90.0)))],
                PoreModelSet.instance().get_model(
                    "r9.4_450bps", "nucleotide", "template", 6), 6, **kw),
    }


class _Events:
    def __init__(self, mean):
        self.mean = mean

    def __len__(self):
        return len(self.mean)


def _seg_tensors(device=None, ev=np.full((8, 1), 90.0, np.float32)):
    """The segmentation kernels' inputs for one 8-sample read, made on
    ``device`` as a caller would make them."""
    from nanopolish_tpu_torch.ops.segmentation_hmm import (SegmentationParams,
                                                           seg_constants)
    dev = resolve_device(device)
    return (torch.as_tensor(ev, device=dev),
            torch.tensor([8], dtype=torch.int32, device=dev),
            torch.tensor([[1.0, 0.0, 1.0]], device=dev),
            seg_constants(SegmentationParams()))


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


def test_every_subcommand_of_the_jax_package_dispatches():
    """Every subcommand of nanopolish_tpu.__main__ has its own module in
    the port, with a main; nothing answers "not yet ported"."""
    import importlib

    from nanopolish_tpu import __main__ as jax_main
    from nanopolish_tpu_torch import __main__ as port_main
    assert set(jax_main.SUBCOMMANDS) <= set(port_main.SUBCOMMANDS)
    assert not hasattr(port_main, "NOT_PORTED")
    for name in jax_main.SUBCOMMANDS:
        mod = importlib.import_module(
            f"nanopolish_tpu_torch.apps.{name.replace('-', '_')}")
        assert callable(mod.main), name
    r = subprocess.run([sys.executable, "-m", "nanopolish_tpu_torch"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    listed = {ln.strip() for ln in r.stderr.splitlines()}
    assert set(jax_main.SUBCOMMANDS) <= listed


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_trained_model_files_carry_across(tmp_path, direction):
    """A model file written as the port's methyltrain writes its rounds
    (PoreModel.with_states(...).write) loads into the JAX PoreModelSet
    through a fofn with arrays equal to the port's own load of it, and
    the other way round."""
    from nanopolish_tpu_torch.models.pore_model import PoreModel, PoreModelSet
    from nanopolish_tpu.models.pore_model import PoreModel as JaxModel
    key = ("r9.4_450bps", "cpg", "template", 6)
    rng = np.random.default_rng(5)
    src_set, dst_set = (PoreModelSet, JaxModels) \
        if direction == "port_to_jax" else (JaxModels, PoreModelSet)
    src = src_set.instance().get_model(*key)
    trained = src.with_states(
        src.level_mean + rng.normal(0, 1, src.num_states).astype(np.float32),
        src.level_stdv * rng.uniform(0.8, 1.2, src.num_states))
    name = "r9.4_450bps.cpg.6mer.template.round0.model"
    path = str(tmp_path / name)
    trained.write(path, name)
    fofn = tmp_path / "models.fofn"
    fofn.write_text(path + "\n")
    dst_set.reset()
    try:
        loaded = dst_set.instance().initialize(str(fofn))[0]
        assert dst_set.instance().get_model(*key) is loaded
        assert loaded.key() == key and loaded.name == name
    finally:
        dst_set.reset()
    own = (PoreModel if direction == "jax_to_port" else JaxModel
           ).from_file(path)
    for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv",
              "level_log_stdv", "sd_lambda", "sd_log_lambda"):
        np.testing.assert_array_equal(getattr(loaded, f), getattr(own, f),
                                      err_msg=f)
    np.testing.assert_allclose(loaded.level_mean, trained.level_mean,
                               atol=5e-7)


@pytest.mark.parametrize("kernel", ["seg_viterbi_fill", "seg_backtrack"])
def test_segmentation_wrappers_raise_off_cpu_and_cuda(kernel):
    """A tensor on neither the CPU nor a CUDA device reaches no kernel
    and no plain version: the wrapper raises."""
    from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
    x, n, scal, k = _seg_tensors(device="cpu")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if kernel == "seg_viterbi_fill":
            sv.seg_viterbi_fill(x.to(meta), n.to(meta), scal.to(meta), k)
        else:
            sv.seg_backtrack(torch.zeros((8, 1), dtype=torch.uint8,
                                         device=meta), n.to(meta))


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
