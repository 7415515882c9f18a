"""The port's table-route Forward (``NPT_LOGSUM=table``) against the JAX
package's.

Under ``NPT_LOGSUM=table`` the JAX scan sums every Forward term with
hmmer3's 0.001-nat quantized ``p7_FLogsum`` table (``utils/logsum.py``)
and runs the K chain kmer after kmer; the port's plain table route
(``ops/profile_hmm.forward_fill_plain(..., logsum="table")``, the plain
version of ``csrc/forward_table.cu``) does the same operations.  There is
no exp or log in the recurrence, so the bar is bit for bit, once both
sides use one transition table (the port's; the JAX scan's own is a few
ulp away, tests/test_torch_scorereads_phase.py).  Against the JAX
package's native CPU baseline (``csrc/cpu_profile_hmm.cpp``, which sums
in another order) the bar is its own test's: abs 5e-3 nats
(tests/test_cpu_baseline_hmm.py).

The dispatch tests stub the plain Forwards (zeros) and record the route
of every call: each caller of the Forward reaches the table route under
``NPT_LOGSUM=table`` and the exact one without it.
"""

import ctypes
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopolish_tpu.ops.profile_hmm import _kstate_scan, profile_hmm_forward
from nanopolish_tpu.utils.logsum import add_logs_table as jax_add_logs_table
from nanopolish_tpu.utils.native import get_native_lib
from nanopolish_tpu_torch.apps import call_methylation as cm
from nanopolish_tpu_torch.apps import phase_reads as pr
from nanopolish_tpu_torch.apps import scorereads as sc
from nanopolish_tpu_torch.apps import variants as va
from nanopolish_tpu_torch.ops import profile_hmm as ph
from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
from nanopolish_tpu_torch.ops.profile_hmm_viterbi import prepare_viterbi_inputs
from nanopolish_tpu_torch.parallel import (TrainBatch, make_mesh,
                                           make_train_step, shard_model,
                                           shard_reads)
from nanopolish_tpu_torch.utils.logsum import (P7_LOGSUM_CLAMP,
                                               add_logs_table, logsum_mode)
from tests.test_torch_call_methylation import meth_pipe  # noqa: F401
from tests.test_torch_forward import _batch, _jax_trans
from tests.test_torch_scorereads_phase import phased_pipeline  # noqa: F401
from tests.test_torch_variants import golden_pipe  # noqa: F401

torch.set_num_threads(2)

NATIVE_ATOL = 5e-3


def _f32(*v):
    return np.array(v, np.float32)


def test_add_logs_table_matches_jax_on_edges():
    """-inf on one side and both, equal inputs, d one ulp below, at and
    above 15.7, d at the last table entry (15.999), and random pairs."""
    inf = np.float32(np.inf)
    cut = np.float32(P7_LOGSUM_CLAMP)
    below, above = np.nextafter(cut, np.float32(0)), np.nextafter(cut, inf)
    x = _f32(-inf, -inf, 2.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0.0, -7.25)
    y = _f32(-inf, 1.0, -inf, 3.0, -below, -cut, -above, -15.999, -15.9995,
             -7.2505)
    rng = np.random.default_rng(0)
    rx = rng.normal(-50, 10, 20000).astype(np.float32)
    ry = (rx - rng.uniform(0, 17, 20000)).astype(np.float32)
    x, y = np.concatenate([x, rx]), np.concatenate([y, ry])
    for a, b in ((x, y), (y, x)):
        want = np.asarray(jax_add_logs_table(jnp.asarray(a), jnp.asarray(b)))
        got = add_logs_table(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == -np.inf and got[3] == np.float32(3.0) + \
        np.float32(np.log(2.0))
    # one ulp below the cut reads the table; at the cut and above, max
    assert got[4] != 0.0 and got[5] == got[6] == got[7] == got[8] == 0.0


@pytest.mark.parametrize("K", [1, 7, 40])
def test_kstate_chain_table_matches_jax(K):
    rng = np.random.default_rng(K)
    c = rng.normal(-30, 8, (5, K)).astype(np.float32)
    c[0, ::3] = -np.inf
    lp_kk = np.full(5, np.log(0.3), np.float32)
    want = np.asarray(_kstate_scan(jnp.asarray(c), jnp.asarray(lp_kk), False,
                                   add=jax_add_logs_table))
    got = ph.kstate_chain_table(torch.from_numpy(c),
                                torch.from_numpy(lp_kk)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _flat(B, K, T, seed, flags):
    """A batch of _batch with segment 0 of no event and 1 of one event, as
    numpy (levels, n_events, mu, sigma, n_kmers, epb) and the port's
    padded tensors on the CPU."""
    lv, Ts, mu, sd, Ks, epb = _batch(B, K, T, seed=seed, full=K < 4)
    Ts[0] = 0
    if B > 1:
        Ts[1] = 1
    x = prepare_viterbi_inputs(lv, Ts, mu, sd, Ks, epb,
                               np.full(B, flags, np.int32), 1.0,
                               ph.make_transitions(epb), device="cpu")
    return (lv, Ts, mu, sd, Ks, epb), x


def _plain_table(x):
    return ph.forward_fill_plain(
        x["levels"], x["n_events"], x["mu"], x["sigma"], x["c"],
        x["n_kmers"], x["trans"], x["clips"], logsum="table").numpy()


@pytest.mark.parametrize("shape", [(8, 30, 60), (4, 120, 90), (3, 300, 40),
                                   (3, 5, 20), (2, 1, 12), (2, 1100, 6)])
@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_plain_table_matches_jax_scan(shape, flags, monkeypatch):
    """Widths 1 to 300 kmers and one of 1,100 with few rows; bit for bit,
    the JAX scan given the port's transition table."""
    B, K, T = shape
    (lv, Ts, mu, sd, Ks, epb), x = _flat(B, K, T, 10 * K + flags, flags)
    monkeypatch.setenv("NPT_LOGSUM", "table")
    want = np.asarray(profile_hmm_forward(
        lv, Ts, mu, sd, np.log(sd), Ks, epb, flags=flags,
        trans=_jax_trans(ph.make_transitions(epb))))
    got = _plain_table(x)
    assert got[0] == -np.inf and np.isfinite(got[1:]).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _native_forward():
    lib = get_native_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    f = lib._lib.npt_cpu_profile_hmm_forward
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                  ctypes.POINTER(ctypes.c_float),
                  ctypes.POINTER(ctypes.c_float),
                  ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                  ctypes.c_float, ctypes.c_int32]
    p = lambda a: np.ascontiguousarray(a).ctypes.data_as(  # noqa: E731
        ctypes.POINTER(ctypes.c_float))
    return lambda lv, mu, sd, epb, flags: f(
        p(lv), len(lv), p(mu), p(sd), p(np.log(sd)), len(mu), epb, flags)


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_plain_table_near_native_cpu_forward(flags):
    """The JAX package's C++ CPU baseline (npt_cpu_profile_hmm_forward,
    csrc/cpu_profile_hmm.cpp:78), which sums with p7_FLogsum in its own
    order: within abs 5e-3 nats."""
    native = _native_forward()
    (lv, Ts, mu, sd, Ks, epb), x = _flat(6, 50, 120, 40 + flags, flags)
    got = _plain_table(x)
    for b in range(2, 6):
        t, k = int(Ts[b]), int(Ks[b])
        want = native(lv[b, :t], mu[b, :k], sd[b, :k], float(epb[b]), flags)
        assert got[b] == pytest.approx(want, abs=NATIVE_ATOL), (b, t, k)


def test_indexed_table_route_matches_jax_flat():
    """forward_indexed_scores under logsum="table": the flush's windows
    gathered into the flat layout (widths 3-70 kmers across launches),
    equal bit for bit to the JAX scan's table route on the same flat
    inputs, as the JAX package's flat path scores them off the TPU."""
    rng = np.random.default_rng(5)
    lv, Ts, mu, sd, Ks, epb = _batch(6, 70, 90, seed=3)
    E, U = 6, 9
    n_km = rng.integers(3, 71, U).astype(np.int32)
    rank_mat = np.zeros((U, int(n_km.max())), np.int32)
    for u in range(U):
        rank_mat[u, :n_km[u]] = rng.integers(0, 64, n_km[u])
    tab_mu = rng.uniform(70, 120, (2, 64)).astype(np.float32)
    tab_sd = rng.uniform(1.5, 3.0, (2, 64)).astype(np.float32)
    tabs = np.stack([tab_mu, tab_sd, ph.LOG_INV_SQRT_2PI -
                     np.log(tab_sd)]).astype(np.float32)
    trans_u = ph.make_transitions(epb[:2])
    ids = np.stack([rng.integers(0, E, 40), rng.integers(0, 2, 40),
                    rng.integers(0, U, 40), rng.integers(0, 2, 40)],
                   axis=1).astype(np.int32)
    Ts[0] = 1
    got = pi.forward_indexed_scores(lv, Ts, tabs, rank_mat, n_km, trans_u,
                                    ids, 3, device="cpu", logsum="table")
    ev, tb, rr, tr = ids.T
    kmask = np.arange(rank_mat.shape[1])[None, :] < n_km[rr][:, None]
    mu_f = np.where(kmask, tab_mu[tb[:, None], rank_mat[rr]], 0.0)
    sd_f = np.where(kmask, tab_sd[tb[:, None], rank_mat[rr]], 1.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NPT_LOGSUM", "table")
        want = np.asarray(profile_hmm_forward(
            lv[ev], Ts[ev], mu_f.astype(np.float32), sd_f.astype(np.float32),
            np.log(sd_f).astype(np.float32), n_km[rr], epb[tr], flags=3,
            trans=_jax_trans(trans_u[tr])))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_logsum_mode_reads_the_environment(monkeypatch):
    monkeypatch.delenv("NPT_LOGSUM", raising=False)
    assert logsum_mode() == "exact"
    for value, mode in (("table", "table"), ("exact", "exact"),
                        ("TABLE", "exact"), ("", "exact")):
        monkeypatch.setenv("NPT_LOGSUM", value)
        assert logsum_mode() == mode


def test_table_route_on_cuda_tensors_needs_the_kernel():
    """A CPU tensor takes the plain version; any other device launches
    the kernel or raises (no fallback)."""
    (_, x) = _flat(3, 20, 30, 1, 3)
    args = [x[k] for k in ("levels", "n_events", "mu", "sigma", "c",
                           "n_kmers", "trans", "clips")]
    np.testing.assert_array_equal(
        pf.forward_fill(*args, logsum="table").numpy(), _plain_table(x))
    with pytest.raises(ValueError, match="no kernel for device"):
        pf.forward_table(*[a.to("meta") for a in args])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (csrc/forward_table.cu)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain(cuda_device):
    """csrc/forward_table.cu against the plain table route, bit for bit,
    at one and several 32-kmer strips."""
    for K, T in ((20, 60), (300, 40)):
        (_, x) = _flat(6, K, T, K, 3)
        args = [x[k].to(cuda_device) for k in (
            "levels", "n_events", "mu", "sigma", "c", "n_kmers", "trans",
            "clips")]
        got = pf.forward_table(*args).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      _plain_table(x).view(np.int32))


# ------------------------------------------------------ dispatch per caller --

@pytest.fixture
def routes(monkeypatch):
    """Stub the plain Forwards with zeros; every call appends its route:
    "table", "exact" (forward_fill_plain) or "indexed"
    (forward_indexed_plain, the exact indexed drain)."""
    calls = []

    def fill(levels, *args, logsum="exact"):
        calls.append("table" if logsum == "table" else "exact")
        return torch.zeros(levels.shape[0])

    def indexed(*args):
        calls.append("indexed")
        return torch.zeros(args[6].shape[0])

    monkeypatch.setattr(pf, "forward_fill_plain", fill)
    monkeypatch.setattr(pi, "forward_indexed_plain", indexed)
    return calls


def _cm_args(p):
    return ["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"], "--device",
            "cpu"]


def _call_methylation(req):
    cm.main(_cm_args(req.getfixturevalue("meth_pipe")), stdout=io.StringIO())


# the (read, strand, fai, contig, alignment) items of scorereads' first run
_ITEMS = []


def _scorereads(req):
    p = req.getfixturevalue("phased_pipeline")
    tasks = sc._segment_tasks

    def keep(*args, **kw):
        _ITEMS.append(args)
        return tasks(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        if not _ITEMS:
            mp.setattr(sc, "_segment_tasks", keep)
        sc.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"],
                 "--max-reads", "1", "--device", "cpu"], stdout=io.StringIO())


def _read_model_scores(req):
    """methyltrain --output-scores' scorer, on the items that scorereads'
    run aligned."""
    if not _ITEMS:
        _scorereads(req)
        del req.getfixturevalue("routes")[:]
    sc.read_model_scores(_ITEMS, device="cpu")


def _phase_reads(req):
    p = req.getfixturevalue("phased_pipeline")
    pr.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["ref_fa"], p["vcf"],
             "--device", "cpu"], stdout=io.StringIO())


def _variants(req):
    """--consensus screens through the indexed drain; --fix-homopolymers
    scores through forward_segments (variants.py's final scoring)."""
    p = req.getfixturevalue("golden_pipe")
    va.main(["-r", p["fastq"], "-b", p["bam"], "-g", p["draft_fa"], "-w",
             "tig1:0-299", "--consensus", "-d", "5", "--fix-homopolymers",
             "-o", str(p["dir"] / "routes.vcf"), "--device", "cpu"])


def _train_step(req):
    from tests.test_torch_parallel import N_RANKS, train_batch
    level_mean, level_stdv, arrays = train_batch()
    mesh = make_mesh(1)
    make_train_step(mesh, N_RANKS, device="cpu")(
        *shard_model(mesh, level_mean, level_stdv),
        TrainBatch(*shard_reads(mesh, *arrays)))


CALLERS = {"call-methylation": _call_methylation, "scorereads": _scorereads,
           "read_model_scores": _read_model_scores,
           "phase-reads": _phase_reads, "variants": _variants,
           "train_step": _train_step}


@pytest.mark.parametrize("mode", ["table", "exact"])
@pytest.mark.parametrize("caller", list(CALLERS))
def test_caller_takes_the_route_of_npt_logsum(caller, mode, routes, request,
                                              monkeypatch):
    if mode == "table":
        monkeypatch.setenv("NPT_LOGSUM", "table")
    else:
        monkeypatch.delenv("NPT_LOGSUM", raising=False)
    CALLERS[caller](request)
    assert routes, f"{caller} reached no Forward"
    if mode == "table":
        assert set(routes) == {"table"}, routes
    else:
        assert "table" not in routes, routes
