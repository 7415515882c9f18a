"""nanopolish_tpu_torch's multi-process execution against the JAX
package's: ops/training, the process mesh, the sharded train step, the
process runtime (auto_init) and the shard launcher.

The port runs on the CPU in spawned children over gloo, which import no
jax (``sys.modules["jax"] = None``); the JAX side runs in this process on
conftest's 8-device virtual CPU mesh, on the same seeded NumPy inputs.

Tolerances of the train step (PERF.md §2's EM tolerance):
  * ``n_scored`` equal;
  * trained means within 1e-4 pA and stdvs within 1e-3 relative, every
    difference counted.  The JAX step sums the moments in f32 (XLA's
    scatter-add in read order, then a psum), the port in f64 rounded to
    f32 once; the stdv of a well-filled kmer is a difference of two
    ~1e4 terms, so the JAX sums' rounding reaches the stdv at a few 1e-4;
  * the loss within 2e-3 nats or 1e-5 relative, whichever is larger: a
    whole read's Forward log-likelihood is of order 1e3 nats here (1e4
    on an 8 kb read), where the f32 sum over reads is already a few ulp
    of 1e-4 apart, and the JAX Forward's exp and log1p are XLA's own.
"""

import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nanopolish_tpu.apps import index as index_app
from nanopolish_tpu.io.bam import BamRecord, BamWriter
from nanopolish_tpu.io.slow5 import Slow5Writer
from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.models.squiggle import SquiggleScalings
from nanopolish_tpu.ops import training as jtr
from nanopolish_tpu.parallel import mesh as jmesh
from nanopolish_tpu.parallel import train_step as jstep
from nanopolish_tpu.utils.alphabet import DNA_ALPHABET, METHYL_CPG_ALPHABET
from nanopolish_tpu.utils.synthetic import random_sequence, synthetic_raw_signal
from nanopolish_tpu_torch.ops import training as ptr
from nanopolish_tpu_torch.parallel import mesh as pmesh
from nanopolish_tpu_torch.parallel import train_step as pstep
from nanopolish_tpu_torch.parallel.launch import free_port

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_ATOL, STDV_RTOL = 1e-4, 1e-3
LOSS_ATOL, LOSS_RTOL = 2e-3, 1e-5
# the train step's batch: READS real reads padded to a multiple of 4
# (the padded read must be inert), T events and K kmers each, the kmer
# ranks drawn from POOL so that every model shard of the 4,096-state
# table holds kmers of over 100 'M' events
READS, T, K = 3, 600, 300
POOL = np.array([100, 1500, 1900, 2300, 3100, 3900])
N_RANKS = 4096
CHILD_TIMEOUT = 120


def _child_env(extra=None):
    env = dict(os.environ)
    env.update(PYTHONPATH=os.pathsep.join([ROOT] + sys.path),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("NPT_COORDINATOR", None)
    env.update(extra or {})
    return env


def _spawn(n, argv, **kw):
    """n children running ``argv`` with the launcher's NPT_* env."""
    coord = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_child_env({"NPT_COORDINATOR": coord, "NPT_NUM_PROCS": str(n),
                        "NPT_PROC_ID": str(i)}), **kw) for i in range(n)]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode())
    finally:
        _kill(procs)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"child {i}:\n{outs[i]}"
    return outs


# ------------------------------------------------------------ ops/training --

def _moment_inputs(case, rng, n_ranks=64, shape=(6, 50)):
    ranks = rng.integers(0, n_ranks, shape).astype(np.int32)
    levels = rng.normal(90.0, 8.0, shape).astype(np.float32)
    weights = (rng.random(shape) < 0.8).astype(np.float32)
    if case == "responsibilities":
        weights *= rng.random(shape).astype(np.float32)
    if case == "nan_masked":
        levels[weights == 0] = np.nan
    if case == "out_of_range":
        ranks[:, ::7] = -3
        ranks[:, 3::7] = n_ranks + 5
    return ranks, levels, weights, n_ranks


@pytest.mark.parametrize("case", ["plain", "responsibilities", "nan_masked",
                                  "out_of_range"])
def test_kmer_moments_match_jax(case):
    ranks, levels, weights, R = _moment_inputs(case, np.random.default_rng(3))
    got = ptr.kmer_moments(torch.as_tensor(ranks), torch.as_tensor(levels),
                           torch.as_tensor(weights), R)
    want = jtr.kmer_moments(ranks, levels, weights, R)
    # the port's f64 sums equal a sequential f64 NumPy scatter
    r = np.clip(ranks.ravel(), 0, R - 1)
    w = weights.ravel().astype(np.float64)
    x = np.where(w > 0, levels.ravel().astype(np.float64), 0.0)
    for name, v in (("n", w), ("x", w * x), ("x2", w * x * x)):
        ref = np.zeros(R)
        np.add.at(ref, r, v)
        g = getattr(got, name)
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), ref, err_msg=name)
        # the JAX sums are f32 in read order: within their rounding
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-6, atol=1e-6, err_msg=name)
    assert np.all(np.isfinite(np.stack([g.numpy() for g in got])))


def test_merge_moments_matches_jax():
    rng = np.random.default_rng(4)
    a = ptr.kmer_moments(*[torch.as_tensor(v) for v in
                           _moment_inputs("plain", rng)[:3]], 64)
    b = ptr.kmer_moments(*[torch.as_tensor(v) for v in
                           _moment_inputs("plain", rng)[:3]], 64)
    got = ptr.merge_moments(a, b)
    want = jtr.merge_moments(jtr.KmerMoments(*(v.numpy() for v in a)),
                             jtr.KmerMoments(*(v.numpy() for v in b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("min_events", [100.0, 3.0])
def test_gaussian_update_matches_jax(min_events):
    """On the same f32 sums the port's M-step is the jitted JAX one's
    (the train step's), bit for bit: XLA fuses the variance's
    ``x2/n - mean*mean`` into one fused multiply-add, as the port's
    ``fma32`` rounds it; op-by-op JAX rounds the product apart."""
    rng = np.random.default_rng(5)
    R = 256
    n = rng.integers(0, 300, R).astype(np.float32)
    mean = rng.normal(90.0, 10.0, R)
    sd = rng.uniform(0.5, 4.0, R)
    x = (n * mean).astype(np.float32)
    x2 = (n * (sd * sd + mean * mean)).astype(np.float32)
    prior_m = rng.normal(90.0, 10.0, R).astype(np.float32)
    prior_s = rng.uniform(1.0, 3.0, R).astype(np.float32)
    got = ptr.gaussian_update(
        ptr.KmerMoments(*(torch.as_tensor(v).double() for v in (n, x, x2))),
        torch.as_tensor(prior_m), torch.as_tensor(prior_s), min_events)
    m = jtr.KmerMoments(n, x, x2)
    want = jax.jit(jtr.gaussian_update, static_argnums=3)(
        m, prior_m, prior_s, min_events)
    assert int(np.sum(n >= min_events)) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_psum_moments_without_group_is_identity():
    m = ptr.KmerMoments(*(torch.arange(4, dtype=torch.float64),) * 3)
    assert ptr.psum_moments(m, None) is m


# ------------------------------------------------------------------- mesh --

@pytest.mark.parametrize("n,mp", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 2),
                                  (8, 4)])
def test_mesh_layout_matches_make_mesh(n, mp):
    """Rank r's (data, model) place, its block of reads and its rows of
    the kmer table are those of device r in the JAX mesh."""
    devs = jax.devices()[:n]
    jm = jmesh.make_mesh(devs, model_parallel=mp)
    B, R = 2 * (n // mp), 4 * mp
    reads = np.arange(B)
    table = np.arange(R)
    data_idx = NamedSharding(jm, P(jmesh.DATA_AXIS)).devices_indices_map(
        (B,))
    model_idx = NamedSharding(jm, P(jmesh.MODEL_AXIS)).devices_indices_map(
        (R,))
    for r, dev in enumerate(devs):
        pm = pmesh.Mesh(n // mp, mp, r)
        where = np.argwhere(jm.devices == dev)[0]
        assert (pm.data_index, pm.model_index) == tuple(where)
        assert pm.shape == dict(jm.shape)
        np.testing.assert_array_equal(pmesh.shard_reads(pm, reads),
                                      reads[data_idx[dev][0]])
        np.testing.assert_array_equal(pmesh.shard_model(pm, table),
                                      table[model_idx[dev][0]])
        np.testing.assert_array_equal(table[pmesh.model_rows(pm, R)],
                                      table[model_idx[dev][0]])


def test_mesh_without_process_group_and_bad_splits():
    m = pmesh.make_mesh()
    assert (m.data, m.model, m.rank, m.data_group, m.model_group) == \
        (1, 1, 0, None, None)
    with pytest.raises(ValueError):
        pmesh.make_mesh(model_parallel=2)
    with pytest.raises(ValueError):
        pmesh.shard_reads(pmesh.Mesh(2, 1, 0), np.arange(3))
    x = np.ones((4, 3))
    assert pmesh.replicated(x) is x


@pytest.mark.parametrize("b,multiple", [(3, 4), (4, 2), (5, 3)])
def test_pad_batch_to_multiple_matches_jax(b, multiple):
    rng = np.random.default_rng(b)
    arrays = [rng.normal(size=(b, 5)).astype(np.float32),
              rng.integers(1, 9, b).astype(np.int32)]
    got, real = pmesh.pad_batch_to_multiple(arrays, multiple)
    want, real_j = jmesh.pad_batch_to_multiple(arrays, multiple)
    assert real == real_j == b
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.shape[0] % multiple == 0
    assert np.all(got[1][b:] == 0)       # padded reads: n_events = 0


def test_cpg_table_with_model_axis_2_raises_as_in_jax():
    cpg_states = 5 ** 6
    with pytest.raises(ValueError, match="not divisible"):
        pstep.make_train_step(pmesh.Mesh(1, 2, 0), cpg_states, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        jstep.make_train_step(jmesh.make_mesh(jax.devices()[:2], 2),
                              cpg_states)
    for mp in (1, 5, 25):
        pstep.make_train_step(pmesh.Mesh(1, mp, 0), cpg_states, device="cpu")


# ------------------------------------------------------------- train step --

def train_batch(seed=7):
    """READS reads of T events (2 per kmer, the model's level plus its
    stdv's noise) over K kmers drawn from POOL, padded to 4 reads."""
    model = PoreModelSet.instance().get_model("r9.4_450bps", "nucleotide",
                                              "template", 6)
    rng = np.random.default_rng(seed)
    ranks = POOL[rng.integers(0, len(POOL), (READS, K))].astype(np.int32)
    reps = np.repeat(np.arange(K), 2)[:T]
    ev = np.stack([model.level_mean[r][reps] + rng.normal(
        0, model.level_stdv[r][reps]) for r in ranks]).astype(np.float32)
    ev_time = np.cumsum(np.full((READS, T), 0.0025, np.float32), axis=1)
    arrays, real = jmesh.pad_batch_to_multiple(
        [ev, ev_time, np.full(READS, T, np.int32), ranks,
         np.full(READS, K, np.int32)], 4)
    return (model.level_mean.astype(np.float32),
            model.level_stdv.astype(np.float32), arrays)


_STEP_CHILD = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np, torch
torch.set_num_threads(1)
from nanopolish_tpu_torch.parallel import (TrainBatch, make_mesh,
                                           make_train_step, shard_model,
                                           shard_reads)
from nanopolish_tpu_torch.parallel.distributed import auto_init
inp, out, mp = sys.argv[1], sys.argv[2], int(sys.argv[3])
pid, n = auto_init(device="cpu")
a = np.load(inp)
mesh = make_mesh(mp)
assert mesh.rank == pid and mesh.data * mesh.model == n
step = make_train_step(mesh, int(a["n_ranks"]), device="cpu")
res = step(*shard_model(mesh, a["level_mean"], a["level_stdv"]),
           TrainBatch(*shard_reads(mesh, a["ev_mean"], a["ev_time"],
                                   a["n_events"], a["ranks"],
                                   a["n_kmers"])))
np.savez(out % pid, level_mean=res.level_mean.numpy(),
         level_stdv=res.level_stdv.numpy(), loss=res.loss.numpy(),
         n_scored=res.n_scored.numpy(), data_index=mesh.data_index,
         model_index=mesh.model_index)
print("rank", pid, "ok")
"""


MESHES = [(1, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    """The port's step on every mesh of MESHES, all children started at
    once: {(dp, mp): (children, result path pattern)}."""
    d = tmp_path_factory.mktemp("torch_train_step")
    level_mean, level_stdv, arrays = train_batch()
    inp = str(d / "batch.npz")
    np.savez(inp, level_mean=level_mean, level_stdv=level_stdv,
             n_ranks=N_RANKS, **dict(zip(jstep.TrainBatch._fields, arrays)))
    runs = {}
    for dp, mp in MESHES:
        out = str(d / f"{dp}x{mp}.rank%d.npz")
        runs[(dp, mp)] = (_spawn(dp * mp, [sys.executable, "-c", _STEP_CHILD,
                                           inp, out, str(mp)]), out)
    yield runs
    for procs, _ in runs.values():
        _kill(procs)


@pytest.mark.parametrize("dp,mp", MESHES)
def test_train_step_matches_jax(port_steps, dp, mp):
    level_mean, level_stdv, arrays = train_batch()
    # the JAX step on the same mesh, while the children run
    jm = jmesh.make_mesh(jax.devices()[:dp * mp], model_parallel=mp)
    want = jstep.make_train_step(jm, N_RANKS)(
        level_mean, level_stdv, jstep.TrainBatch(*arrays))
    w_mean, w_stdv = np.asarray(want.level_mean), np.asarray(want.level_stdv)
    procs, out = port_steps[(dp, mp)]
    _wait(procs)
    ranks = [dict(np.load(out % r)) for r in range(dp * mp)]
    # the model shards of data row 0 make the table; every data row agrees
    by_m = {}
    for r in ranks:
        by_m.setdefault(int(r["model_index"]), []).append(r)
    g_mean = np.concatenate([by_m[m][0]["level_mean"] for m in range(mp)])
    g_stdv = np.concatenate([by_m[m][0]["level_stdv"] for m in range(mp)])
    for rows in by_m.values():
        for r in rows[1:]:
            np.testing.assert_array_equal(r["level_mean"],
                                          rows[0]["level_mean"])
            np.testing.assert_array_equal(r["level_stdv"],
                                          rows[0]["level_stdv"])
    for r in ranks:
        assert int(r["n_scored"]) == int(ranks[0]["n_scored"])
        assert float(r["loss"]) == float(ranks[0]["loss"])

    # the padded read is inert: every real read scored, none more
    assert int(ranks[0]["n_scored"]) == int(want.n_scored) == READS
    # every model shard trains at least one kmer, in both packages
    trained = np.nonzero(w_mean != level_mean)[0]
    np.testing.assert_array_equal(np.nonzero(g_mean != level_mean)[0],
                                  trained)
    rows = N_RANKS // mp
    assert set(trained // rows) == set(range(mp)), trained
    # trained values within the EM tolerance, every difference counted
    d_mean = np.abs(g_mean - w_mean)
    d_stdv = np.abs(g_stdv - w_stdv) / w_stdv
    n_diff = int(np.sum((d_mean > 0) | (d_stdv > 0)))
    n_over = int(np.sum((d_mean > MEAN_ATOL) | (d_stdv > STDV_RTOL)))
    print(f"[train step {dp}x{mp}] {len(trained)} kmers trained, "
          f"{n_diff} values differ, {n_over} beyond tolerance; max "
          f"{d_mean.max():.3g} pA, stdv {d_stdv.max():.3g} relative")
    assert n_over == 0
    assert n_diff <= len(trained)       # untrained kmers keep the prior
    loss, w_loss = float(ranks[0]["loss"]), float(want.loss)
    assert np.isfinite(loss)
    assert abs(loss - w_loss) <= max(LOSS_ATOL, LOSS_RTOL * abs(w_loss)), \
        (loss, w_loss)


# ---------------------------------------------------------- process runtime --

_PSUM_CHILD = r"""
import sys
sys.modules["jax"] = None
import torch, torch.distributed as dist
from nanopolish_tpu_torch.parallel.distributed import (all_gather,
                                                       all_reduce, auto_init,
                                                       shard_arg)
pid, n = auto_init(device="cpu")
assert n == 2 and dist.get_world_size() == 2 and dist.get_rank() == pid
assert dist.get_backend() == "gloo"
assert shard_arg() == f"{pid}/2"
out = all_reduce(torch.full((4,), pid + 1.0), dist.group.WORLD)
assert (out == 3.0).all(), out
g = all_gather(torch.full((2,), float(pid)), dist.group.WORLD)
assert g.tolist() == [0.0, 0.0, 1.0, 1.0], g
print(f"proc {pid} all_reduce ok")
"""


def test_cross_process_all_reduce_through_auto_init():
    """Two launcher-style processes join one process group from the
    NPT_* environment and all-reduce across it (the counterpart of
    tests/test_distributed.py::test_cross_process_psum)."""
    outs = _wait(_spawn(2, [sys.executable, "-c", _PSUM_CHILD]))
    for o in outs:
        assert "all_reduce ok" in o
    assert "over gloo (the run is on the CPU)" in outs[0]


@pytest.mark.parametrize("n,cards,on_cuda,backend", [
    (1, 1, True, "nccl"), (4, 4, True, "nccl"), (2, 1, True, "gloo"),
    (4, 1, True, "gloo"), (2, 0, False, "gloo"), (2, 8, False, "gloo")])
def test_backend_rule(monkeypatch, n, cards, on_cuda, backend):
    """nccl when the run is on CUDA with a card per rank, else gloo."""
    from nanopolish_tpu_torch.parallel import distributed as pd
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pd.choose_backend(n, on_cuda)[0] == backend


def test_auto_init_without_coordinator_is_a_no_op():
    from nanopolish_tpu_torch.parallel import distributed as pd
    env = {k: os.environ.pop(k) for k in ("NPT_COORDINATOR", "NPT_NUM_PROCS",
                                          "NPT_PROC_ID") if k in os.environ}
    try:
        assert pd.auto_init(device="cpu") == (0, 1)
        assert pd.auto_init("127.0.0.1:1", 1, 0, device="cpu") == (0, 1)
        assert not torch.distributed.is_initialized()
    finally:
        os.environ.update(env)


def test_join_times_out_without_the_other_ranks():
    """Rank 0 of a two-rank group whose rank 1 never comes raises within
    its join timeout instead of waiting (gloo's default is 30 minutes)."""
    child = ("import sys; sys.modules['jax'] = None\n"
             "from datetime import timedelta\n"
             "from nanopolish_tpu_torch.parallel.distributed import join\n"
             "join(sys.argv[1], 2, 0, 'cpu', timeout=timedelta(seconds=2))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", child,
                        f"127.0.0.1:{free_port()}"], cwd=ROOT,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT)
    assert r.returncode != 0, r.stdout + r.stderr
    assert time.perf_counter() - t0 < 30


@pytest.mark.parametrize("argv,device", [
    (["eventalign", "-r", "r.fq", "-b", "a.bam", "-g", "g.fa"], "cuda"),
    (["eventalign", "-r", "r.fq", "-b", "a.bam", "-g", "g.fa", "--device",
      "cpu"], "cpu"),
    (["call-methylation", "-r", "r.fq", "-b", "a.bam", "-g", "g.fa",
      "--device=cpu", "--shard", "1/2"], "cpu"),
    (["vcf2fasta", "-g", "g.fa", "x.vcf"], "cpu"),
    (["index", "r.fq"], "cpu")])
def test_main_joins_on_the_device_its_app_parses(monkeypatch, argv, device):
    """``python -m nanopolish_tpu_torch`` joins the process group before
    the app runs, on the device the app's own parser gives; an app
    without --device runs on the cpu."""
    from nanopolish_tpu_torch import __main__ as port_main

    class Joined(Exception):
        pass

    def joined(device=None):
        raise Joined(device)

    monkeypatch.setattr(port_main, "auto_init", joined)
    with pytest.raises(Joined) as e:
        port_main.main(argv)
    assert e.value.args[0] == device


# ---------------------------------------------------------------- launcher --

# a stand-in child: ``{i}`` fails at once with status 3 when it is
# argv[1], every other one waits a minute (as a rank waiting for it to
# join would); each writes its pid first
_FAKE_CHILD = ("import os, sys, time\n"
               "open(sys.argv[2] + '/%s.pid' % sys.argv[3], 'w')"
               ".write(str(os.getpid()))\n"
               "sys.exit(3) if sys.argv[1] == sys.argv[3] else time.sleep(60)\n")


@pytest.mark.parametrize("failing,timeout,rc", [("1", None, 3),
                                                ("none", 2.0, 124)])
def test_launch_kills_the_rest_when_a_child_fails(monkeypatch, tmp_path,
                                                  failing, timeout, rc):
    """A child that fails, or the caller's time limit, ends the launch at
    once: the other children are killed and the status is non-zero."""
    from nanopolish_tpu_torch.parallel import launch
    monkeypatch.setattr(launch, "child_argv", lambda args: [
        sys.executable, "-c", _FAKE_CHILD, *args])
    t0 = time.perf_counter()
    got = launch.main(["-n", "3", "--coordinator", "none", "--", failing,
                       str(tmp_path), "{i}"], timeout=timeout)
    assert got == rc
    assert time.perf_counter() - t0 < 30
    pids = list(tmp_path.glob("*.pid"))
    assert len(pids) == 3 or timeout is None   # 2 s: every child started
    for f in pids:                          # none is left running
        with pytest.raises(ProcessLookupError):
            os.kill(int(f.read_text()), 0)

@pytest.fixture(scope="module")
def meth_pipe(tmp_path_factory):
    """tests/test_distributed.py's corpus: 6 reads of 300 bases from a
    1,600-base genome, the even ones with cpg-methylated signal."""
    d = tmp_path_factory.mktemp("torch_dist_meth")
    rng = np.random.default_rng(5150)
    pms = PoreModelSet.instance()
    nuc = pms.get_model("r9.4_450bps", "nucleotide", "template", 6)
    cpg = pms.get_model("r9.4_450bps", "cpg", "template", 6)
    genome = random_sequence(rng, 1600)
    ref_fa = str(d / "ref.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">tig1\n")
        for i in range(0, len(genome), 60):
            fh.write(genome[i:i + 60] + "\n")
    fastq, slow5 = str(d / "reads.fastq"), str(d / "sig.slow5")
    L = 300
    plan = [(f"d{i}", 80 + 180 * i, i % 2 == 1, i % 2 == 0)
            for i in range(6)]
    with open(fastq, "w") as fq, Slow5Writer(slow5) as sw:
        for name, pos, is_rev, is_meth in plan:
            seg = genome[pos:pos + L]
            basecall = DNA_ALPHABET.reverse_complement(seg) if is_rev else seg
            fq.write(f"@{name}\n{basecall}\n+\n{'I' * L}\n")
            sc = SquiggleScalings.from4(0.0, 1.0, 0.0, 1.0)
            model, seq = (cpg, METHYL_CPG_ALPHABET.methylate(basecall)) \
                if is_meth else (nuc, basecall)
            pa = synthetic_raw_signal(rng, seq, model, sc,
                                      samples_per_base=10.0, leader=400,
                                      trailer=100)
            adc = np.clip(pa * 8192.0 / 1400.0, -32000, 32000).astype(np.int16)
            sw.write(name, adc, 8192.0, 0.0, 1400.0, 4000.0)
    index_app.main([fastq, "--slow5", slow5])
    bam = str(d / "aln.bam")
    w = BamWriter(bam, "@HD\tVN:1.6\tSO:coordinate\n", ["tig1"], [len(genome)])
    for name, pos, is_rev, _m in sorted(plan, key=lambda t: t[1]):
        seg = genome[pos:pos + L]
        w.write(BamRecord(qname=name, flag=16 if is_rev else 0, tid=0,
                          pos=pos, mapq=60, cigar=[(0, L)], seq=seg,
                          qual=np.full(L, 30, np.uint8)))
    w.close()
    return dict(dir=d, ref_fa=ref_fa, fastq=fastq, bam=bam)


SUBCOMMANDS = {
    "call-methylation": lambda p, n: ["call-methylation"],
    "eventalign": lambda p, n: ["eventalign", "--summary",
                                str(p["dir"] / f"summary.{n}.{{i}}.tsv")],
}
LAUNCHES = [("call-methylation", 2), ("call-methylation", 3),
            ("eventalign", 2)]


def _argv(p, sub, n):
    return [*SUBCOMMANDS[sub](p, n), "-r", p["fastq"], "-b", p["bam"],
            "-g", p["ref_fa"], "--device", "cpu"]


@pytest.fixture(scope="module")
def launched(meth_pipe):
    """``parallel.launch -n n`` of each of LAUNCHES on the CPU, every
    child its own ``--shard {i}/{n}`` and stdout file, all started at
    once: {(sub, n): (launcher, its stderr file, stdout pattern)}."""
    d = meth_pipe["dir"]
    runs = {}
    for sub, n in LAUNCHES:
        pattern = str(d / f"{sub}.{n}.{{i}}.out")
        err = open(str(d / f"{sub}.{n}.stderr"), "w+")
        argv = [sys.executable, "-m", "nanopolish_tpu_torch.parallel.launch",
                "-n", str(n), "--stdout", pattern, "--",
                *_argv(meth_pipe, sub, n), "--shard", "{i}/{n}"]
        runs[(sub, n)] = (subprocess.Popen(argv, cwd=ROOT, env=_child_env(),
                                           stderr=err), err, pattern)
    yield runs
    for proc, err, _ in runs.values():
        _kill([proc])
        err.close()


def _single(p, sub):
    """The single-process run (in this process): (stdout, summary)."""
    import io

    from nanopolish_tpu_torch.apps import call_methylation, eventalign
    app = {"call-methylation": call_methylation, "eventalign": eventalign}
    buf = io.StringIO()
    app[sub].main(_argv(p, sub, 1)[1:], stdout=buf)
    summary = open(str(p["dir"] / "summary.1.{i}.tsv")).read() \
        if sub == "eventalign" else ""
    return buf.getvalue(), summary


def _rows(text):
    return [ln for ln in text.splitlines()[1:] if ln]


def _union(texts):
    union = set()
    for t in texts:
        r = set(_rows(t))
        assert len(r) == len(_rows(t))
        assert not (union & r), "shards overlap"
        union |= r
    return union


@pytest.mark.parametrize("sub,n", LAUNCHES)
def test_launch_shard_union_matches_single_process(meth_pipe, launched, sub,
                                                   n):
    single, single_sum = _single(meth_pipe, sub)
    rows1 = set(_rows(single))
    assert rows1, "single-process run produced no rows"
    proc, err, pattern = launched[(sub, n)]
    assert proc.wait(timeout=CHILD_TIMEOUT) == 0
    err.seek(0)
    stderr = err.read()
    shards = [open(pattern.replace("{i}", str(i))).read() for i in range(n)]
    assert _union(shards) == rows1
    if sub == "eventalign":
        sums = [open(str(meth_pipe["dir"] / f"summary.{n}.{i}.tsv")).read()
                for i in range(n)]
        assert _union(sums) == set(_rows(single_sum))
    # every child joined one gloo group (rank 0 says so once)
    assert stderr.count(f"{n} processes joined torch.distributed over "
                        f"gloo") == 1, stderr
