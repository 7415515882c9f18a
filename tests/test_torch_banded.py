"""nanopolish_tpu_torch banded alignment against the JAX package.

The port's plain PyTorch band fill + walk replay (ops/banded_align.py,
the plain version of csrc/banded_fill.cu and csrc/banded_backtrack.cu)
must reproduce the JAX scan path (nanopolish_tpu.ops.banded_align)
bit for bit on the cases of tests/test_pallas_banded_exact.py: every
BandedAlignResult field identical, f32 fields compared by their bits.
Both sides get the same inputs (numpy, from a seed) and the same
transition terms (transition_params_f32).  The kernels themselves run
only on a GPU (marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.ops.banded_align import banded_align_batch as jax_banded
from nanopolish_tpu.ops.pallas_banded_exact import banded_align_exact as jax_exact
from nanopolish_tpu_torch.ops import banded_align as ba
from nanopolish_tpu_torch.ops import banded_exact as bx

torch.set_num_threads(2)


def _synthetic(B, K, T, epk=2.1, seed=0, noise=1.0, garbage=False):
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, 4096, size=(B, K)).astype(np.int32)
    mu = model.level_mean[ranks].astype(np.float32)
    sigma = model.level_stdv[ranks].astype(np.float32)
    if garbage:
        return rng.uniform(0, 200, size=(B, T)).astype(np.float32), mu, sigma
    reps = np.minimum((np.arange(T) / epk).astype(int), K - 1)
    ev = (mu[:, reps] + rng.normal(0, noise, size=(B, T)).astype(np.float32)
          * sigma[:, reps]).astype(np.float32)
    return ev, mu, sigma


def _assert_identical(ref, got):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).cpu().numpy()
        assert a.shape == b.shape, f
        if a.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


CASES = {
    "clean": dict(K=220, T=470, noise=1.0, seed=23,
                  nev=[470, 380, 470, 410], nk=[220, 180, 220, 200]),
    "noisy": dict(K=220, T=470, noise=2.5, seed=23,
                  nev=[470, 380, 470, 410], nk=[220, 180, 220, 200]),
    "noisy_nonpow2": dict(K=257, T=530, noise=3.0, seed=11,
                          nev=[530] * 4, nk=[257] * 4),
    "mixed": dict(K=280, T=590, noise=1.0, seed=31,
                  nev=[590, 95, 590, 160], nk=[280, 45, 280, 80]),
    "tiny_40x90": dict(K=40, T=90, noise=1.0, seed=5, epk=90 / 40,
                       nev=[90] * 4, nk=[40] * 4),
    "tiny_126x130": dict(K=126, T=130, noise=1.0, seed=5, epk=130 / 126,
                         nev=[130] * 4, nk=[126] * 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_scan_bitwise(case):
    c = CASES[case]
    ev, mu, sigma = _synthetic(4, c["K"], c["T"], epk=c.get("epk", 2.1),
                               seed=c["seed"], noise=c["noise"])
    nev = np.array(c["nev"], np.int32)
    nk = np.array(c["nk"], np.int32)
    lp_stay, lp_step = ba.transition_params_f32(nev, nk)
    ref = jax_banded(ev, nev, mu, sigma, np.log(sigma), nk,
                     lp_stay=lp_stay, lp_step=lp_step)
    got = ba.banded_align_batch(ev, nev, mu, sigma, np.log(sigma), nk,
                                lp_stay=lp_stay, lp_step=lp_step,
                                device="cpu")
    _assert_identical(ref, got)
    # the wrapper takes the plain path for CPU tensors
    _assert_identical(ref, bx.banded_align_exact(
        ev, nev, mu, sigma, np.log(sigma), nk, lp_stay, lp_step,
        device="cpu"))


def test_garbage_reads_fail_qc_like_jax():
    ev, mu, sigma = _synthetic(2, 300, 640, seed=9, garbage=True)
    nev = np.full(2, 640, np.int32)
    nk = np.full(2, 300, np.int32)
    lp_stay, lp_step = ba.transition_params_f32(nev, nk)
    ref = jax_banded(ev, nev, mu, sigma, np.log(sigma), nk,
                     lp_stay=lp_stay, lp_step=lp_step)
    got = ba.banded_align_batch(ev, nev, mu, sigma, np.log(sigma), nk,
                                device="cpu")
    _assert_identical(ref, got)
    assert bool(got.failed.all())
    assert bool((got.b2e_start == -1).all())


def test_plain_matches_pallas_interpret_tiny():
    """At one tiny shape, also against the Pallas kernel in interpret
    mode (its own transition terms are transition_params_f32 too)."""
    ev, mu, sigma = _synthetic(4, 40, 90, epk=90 / 40, seed=5)
    nev = np.array([90, 90, 70, 90], np.int32)
    nk = np.array([40, 40, 35, 38], np.int32)
    ref = jax_exact(ev, nev, mu, sigma, np.log(sigma), nk, interpret=True)
    got = ba.banded_align_batch(ev, nev, mu, sigma, np.log(sigma), nk,
                                device="cpu")
    _assert_identical(ref, got)


def test_fill_layout_and_band_positions():
    """The packed trace/placement layout the kernels share: band 1's
    trim cell, ll_e reconstruction from the placement bits."""
    ev, mu, sigma = _synthetic(2, 40, 90, epk=90 / 40, seed=3)
    x = ba.prepare_banded_inputs(ev, [90, 90], mu, sigma, np.log(sigma),
                                 [40, 40], device="cpu")
    trace, moves, lle, best_e, best_s = ba.banded_fill_plain(
        x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
        x["n_kmers"], x["lp_stay"], x["lp_step"])
    n_bands = ba.n_bands_for(90, 40)
    assert trace.shape == (2, n_bands, ba.TRACE_BYTES)
    assert moves.shape == (2, n_bands)
    assert int(trace[0, 1, 12]) == ba.FROM_U << 4
    ll = ba.band_lower_left_events(moves, lle)
    assert ll[:, 0].tolist() == [49, 49] and ll[:, 1].tolist() == [50, 50]
    assert ll[:, -1].tolist() == lle.tolist()
    assert bool(torch.isfinite(best_s).all())
    assert bool(((best_e >= 0) & (best_e < 90)).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA banded kernels have no "
                    "CPU mode (their plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "tiny_126x130"])
def test_kernels_match_plain_on_gpu(case, cuda_device):
    c = CASES[case]
    ev, mu, sigma = _synthetic(4, c["K"], c["T"], epk=c.get("epk", 2.1),
                               seed=c["seed"], noise=c["noise"])
    x = ba.prepare_banded_inputs(ev, c["nev"], mu, sigma, np.log(sigma),
                                 c["nk"], device=cuda_device)
    args = (x["event_mean"], x["n_events"], x["mu"], x["sigma"], x["c"],
            x["n_kmers"], x["lp_stay"], x["lp_step"])
    fk = bx.banded_fill(*args)
    fp = ba.banded_fill_plain(*args)
    for a, b in zip(fk, fp):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    tail = (x["event_mean"], x["mu"], x["sigma"], x["c"], x["n_kmers"])
    bk = bx.banded_backtrack(fk[0], fk[1], fk[2], fk[3], *tail)
    bp = ba.banded_backtrack_plain(fp[0], fp[1], fp[2], fp[3], *tail)
    for a, b in zip(bk, bp):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
