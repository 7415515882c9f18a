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

import os
import re

import numpy as np
import pytest
import torch

from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.ops.banded_align import _banded_forward as jax_forward
from nanopolish_tpu.ops.banded_align import banded_align_batch as jax_banded
from nanopolish_tpu.ops.pallas_banded_exact import banded_align_exact as jax_exact
from nanopolish_tpu_torch.ops import banded_align as ba
from nanopolish_tpu_torch.ops import banded_exact as bx
from nanopolish_tpu_torch.ops.emissions import fma32, log_normal_fused
from tests import backtrack_chunks as bc

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
    # bands that run along an edge: far more kmers than events (the band
    # moves right nearly every band) and far more events than kmers
    "edge_kmers": dict(K=300, T=120, noise=1.0, seed=7, epk=0.4,
                       nev=[120, 90, 120, 60], nk=[300, 300, 250, 300]),
    "edge_events": dict(K=40, T=400, noise=1.0, seed=8, epk=10.0,
                        nev=[400, 400, 300, 400], nk=[40, 30, 40, 25]),
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


def _kernel_constant(name, kernel="banded_fill"):
    src = open(os.path.join(os.path.dirname(bx.__file__), "..", "csrc",
                            f"{kernel}.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def ring_fill(x, lookahead):
    """banded_fill_plain's recurrence with every emission taken from a
    model of csrc/banded_fill.cu's producer ring: chunks of ``lookahead``
    bands, each band a slot of 100 + 2 lookahead emissions along its
    anti-diagonal (e + k = band - 2) from kmer kb on, kb the chain's ll_k
    at the end of the chunk before the previous one.  Asserts that every
    slot the chain reads (both placements' candidates at each of the 100
    offsets) lies in the slot, and that the bands the kernel takes as
    steady (no edge rules) have only valid cells below offset 100, none
    in the trim column, and the last kmer past the band.  Returns
    banded_fill_plain's outputs and the number of steady bands."""
    ev, nev, mu, sigma, c = (x[k] for k in ("event_mean", "n_events", "mu",
                                            "sigma", "c"))
    nk, lps, lpt = x["n_kmers"], x["lp_stay"], x["lp_step"]
    B, T = ev.shape
    K = mu.shape[1]
    n_bands = ba.n_bands_for(T, K)
    span = ba.BANDWIDTH + 2 * lookahead
    f32, i64 = torch.float32, torch.int64
    offs = torch.arange(ba.LANES, dtype=i64)[None, :]
    inband = offs < ba.BANDWIDTH
    neg = torch.tensor(float("-inf"), dtype=f32)
    lp_skip = torch.tensor(float(np.float32(ba.LP_SKIP)), dtype=f32)
    lp_trim = torch.tensor(float(np.float32(ba.LP_TRIM)), dtype=f32)
    nev64, nk64 = nev.to(i64)[:, None], nk.to(i64)[:, None]
    trace = torch.zeros((B, n_bands, ba.TRACE_BYTES), dtype=torch.uint8)
    moves = torch.zeros((B, n_bands), dtype=torch.uint8)
    half = ba.HALF_BANDWIDTH
    sp2 = torch.where(offs == half, torch.zeros(()), neg).expand(B, -1)
    sp = torch.where(offs == half, lp_trim, neg).expand(B, -1)
    trace[:, 1, half // 4] = ba.FROM_U << (2 * (half % 4))
    ll_e = torch.full((B,), half, dtype=i64)
    ll_k = torch.full((B,), -1 - half, dtype=i64)
    r_prev = torch.zeros(B, dtype=i64)
    best_s = torch.full((B,), float("-inf"), dtype=f32)
    best_e = torch.zeros(B, dtype=i64)
    kbase = [ll_k.clone(), ll_k.clone()]
    n_steady = 0
    t = torch.arange(span, dtype=i64)[None, :]
    n_chunks = -(-(n_bands - 2) // lookahead)
    for ch in range(n_chunks):
        kb = kbase[ch & 1]
        bands = range(2 + ch * lookahead,
                      min(2 + (ch + 1) * lookahead, n_bands))
        ring = []                                # the producers' slots
        for bi in bands:
            k = kb[:, None] + t
            e = (bi - 2 - k).clamp(0, T - 1)
            kc = k.clamp(0, K - 1)
            ring.append(log_normal_fused(
                torch.gather(ev, 1, e), torch.gather(mu, 1, kc),
                torch.gather(sigma, 1, kc), torch.gather(c, 1, kc)))
        for slot, bi in zip(ring, bands):
            cand = ll_k[:, None] - kb[:, None] + offs
            assert bool(((cand >= 0) & (cand + 1 < span))[:, :100].all())
            # the kernel's steady bands skip the edge rules
            steady = (ll_e >= ba.BANDWIDTH - 1) & (ll_e + 1 < nev64[:, 0]) & \
                (ll_k >= 0) & (ll_k + ba.BANDWIDTH + 1 < nk64[:, 0])
            n_steady += int(steady.sum())
            ll, ur = sp[:, 0], sp[:, ba.BANDWIDTH - 1]
            both_ob = torch.isneginf(ll) & torch.isneginf(ur)
            right = torch.where(both_ob, bool(bi % 2 == 1), ll < ur)
            r = right.to(i64)
            ll_e, ll_k = ll_e + (1 - r), ll_k + r
            rb = right[:, None]
            up = torch.where(rb, ba._shift_left(sp, float("-inf")), sp)
            left = torch.where(rb, sp, ba._shift_right(sp, float("-inf")))
            amt = (r_prev + r - 1)[:, None]
            diag = torch.where(amt == 1, ba._shift_left(sp2, float("-inf")),
                               torch.where(amt == 0, sp2, ba._shift_right(
                                   sp2, float("-inf"))))
            ei, ki = ll_e[:, None] - offs, ll_k[:, None] + offs
            valid = (ei >= 0) & (ei < nev64) & (ki >= 0) & (ki < nk64) & inband
            # ... as every cell below offset 100 is valid there, none is
            # in the trim column and the last kmer is past the band
            assert bool((valid == inband)[steady].all())
            assert bool((nk64[:, 0] - 1 - ll_k >= ba.BANDWIDTH)[steady].all())
            em = torch.gather(slot, 1, (ki - kb[:, None]).clamp(0, span - 1))
            sd, su = (diag + lpt[:, None]) + em, (up + lps[:, None]) + em
            sl = left + lp_skip
            m2 = torch.maximum(sd, su)
            f2 = torch.where(m2 == su, ba.FROM_U, ba.FROM_D)
            m3 = torch.maximum(m2, sl)
            code = torch.where(m3 == sl, ba.FROM_L, f2)
            cell = torch.where(valid, m3, neg)
            code = torch.where(valid, code, 0)
            trim = (ki == -1) & (ei >= 0) & (ei < nev64) & inband
            cell = torch.where(trim, lp_trim * (ei.to(f32) + 1.0), cell)
            code = torch.where(trim, ba.FROM_U, code).to(torch.uint8)
            end = fma32(nev.to(f32)[:, None] - ei.to(f32), lp_trim, cell)
            end = torch.where(valid & (ki == nk64 - 1), end, neg)
            cand_s, arg = torch.max(end, dim=1)
            better = cand_s > best_s
            best_s = torch.where(better, cand_s, best_s)
            best_e = torch.where(better, ei[torch.arange(B), arg], best_e)
            trace[:, bi, :] = ba._pack_codes(code)
            moves[:, bi] = r.to(torch.uint8)
            sp2, sp, r_prev = sp, cell, r
        if ch + 2 < n_chunks:
            kbase[ch & 1] = ll_k.clone()
    return (trace, moves, ll_e.to(torch.int32), best_e.to(torch.int32),
            best_s), n_steady


def _inputs(case):
    c = CASES[case]
    ev, mu, sigma = _synthetic(4, c["K"], c["T"], epk=c.get("epk", 2.1),
                               seed=c["seed"], noise=c["noise"])
    return ev, np.array(c["nev"], np.int32), mu, sigma, \
        np.array(c["nk"], np.int32)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


@pytest.mark.parametrize("case", sorted(CASES) + ["garbage"])
def test_producer_ring_matches_plain_and_jax(case):
    """The kernel's producer ring (LOOKAHEAD from csrc/banded_fill.cu)
    covers every emission the chain reads, and the fill fed from it gives
    banded_fill_plain's trace, moves, ll_e_last, best_e and best_s bit for
    bit, and the JAX scan's per-band moves, placements and best event."""
    if case == "garbage":
        ev, mu, sigma = _synthetic(2, 300, 640, seed=9, garbage=True)
        nev, nk = np.full(2, 640, np.int32), np.full(2, 300, np.int32)
    else:
        ev, nev, mu, sigma, nk = _inputs(case)
    x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                 device="cpu")
    lookahead = _kernel_constant("LOOKAHEAD")
    assert ba.BANDWIDTH + 2 * lookahead == 128
    got, n_steady = ring_fill(x, lookahead)
    if case == "clean":
        assert n_steady > 0
    ref = ba.banded_fill_plain(*(x[k] for k in (
        "event_mean", "n_events", "mu", "sigma", "c", "n_kmers", "lp_stay",
        "lp_step")))
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))
    lp_stay, lp_step = ba.transition_params_f32(nev, nk)
    tr, ll_e, best_event = jax_forward(
        ev, nev, mu, sigma, np.log(sigma), nk, lp_stay, lp_step,
        ba.n_bands_for(ev.shape[1], mu.shape[1]))
    codes = np.asarray(tr).transpose(1, 0, 2)       # [B, n_bands, 128]
    packed = got[0].numpy()
    mine = np.stack([(packed >> (2 * q)) & 3 for q in range(4)], axis=-1)
    np.testing.assert_array_equal(mine.reshape(codes.shape), codes)
    ll_e = np.asarray(ll_e).T
    np.testing.assert_array_equal(got[1].numpy()[:, 2:],
                                  (np.diff(ll_e, axis=1) == 0)[:, 1:])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(best_event))


def test_backtrack_chunk_constants_match_kernel():
    """The model's chunk and band width are csrc/banded_backtrack.cu's."""
    assert _kernel_constant("CH", "banded_backtrack") == bc.CH
    assert _kernel_constant("LANES", "banded_backtrack") == bc.LANES == \
        ba.LANES


def _backtrack_inputs(case):
    """banded_backtrack_plain's arguments for a CASES entry (or the
    garbage reads), from the plain fill."""
    if case == "garbage":
        ev, mu, sigma = _synthetic(2, 300, 640, seed=9, garbage=True)
        nev, nk = np.full(2, 640, np.int32), np.full(2, 300, np.int32)
    else:
        ev, nev, mu, sigma, nk = _inputs(case)
    x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                 device="cpu")
    fp = ba.banded_fill_plain(*(x[k] for k in (
        "event_mean", "n_events", "mu", "sigma", "c", "n_kmers", "lp_stay",
        "lp_step")))
    return (ev, nev, mu, sigma, nk), fp[:4] + tuple(
        x[k] for k in ("event_mean", "mu", "sigma", "c", "n_kmers"))


@pytest.mark.parametrize("case", sorted(CASES) + ["garbage"])
def test_chunked_walk_matches_plain_and_jax(case):
    """The model of the kernel's walk (tests/backtrack_chunks.py: chunks,
    band jumps, the moves as the path, the rebuilt events and kmers, the
    ordered summed emission, the kmer-skip runs and base->event writes
    across chunks) gives banded_backtrack_plain's four outputs bit for
    bit, and after QC the JAX scan path's BandedAlignResult; its walks
    cross chunk edges on D moves, and most chunks skip the end tests."""
    (ev, nev, mu, sigma, nk), args = _backtrack_inputs(case)
    *got, counts = bc.chunked_backtrack(*args)
    for a, b in zip(got, ba.banded_backtrack_plain(*args)):
        assert torch.equal(_bits(a), _bits(b))
    lp_stay, lp_step = ba.transition_params_f32(nev, nk)
    ref = jax_banded(ev, nev, mu, sigma, np.log(sigma), nk,
                     lp_stay=lp_stay, lp_step=lp_step)
    _assert_identical(ref, ba.finish_banded(*got, args[-1]))
    assert counts["d_over_edge"] > 0
    if case in ("clean", "noisy", "mixed"):
        assert counts["chunks"] > counts["far"] > counts["chunks"] // 2


def test_chunked_walk_one_read_d_move_over_chunk_edge():
    """One read whose walk jumps over the first band of a chunk on a D
    move (the offset change then spans two chunks' placement bits)."""
    _, args = _backtrack_inputs("clean")
    one = tuple(a[:1] for a in args)
    *got, counts = bc.chunked_backtrack(*one)
    assert counts["d_over_edge"] > 0
    for a, b in zip(got, ba.banded_backtrack_plain(*one)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA banded kernels have no "
                    "CPU mode (their plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["2kb", "garbage"])
def test_kernels_match_plain_on_gpu(case, cuda_device):
    """Every case above, the garbage reads, and one 2 kb read (4,000
    events: ~430 chunks of the fill's producer ring, ~190 of the
    backtrack's), kernels against plain bit for bit."""
    if case == "2kb":
        ev, mu, sigma = _synthetic(1, 2000, 4000, epk=2.0, seed=1)
        nev, nk = np.array([4000], np.int32), np.array([2000], np.int32)
    elif case == "garbage":
        ev, mu, sigma = _synthetic(2, 300, 640, seed=9, garbage=True)
        nev, nk = np.full(2, 640, np.int32), np.full(2, 300, np.int32)
    else:
        ev, nev, mu, sigma, nk = _inputs(case)
    x = ba.prepare_banded_inputs(ev, nev, mu, sigma, np.log(sigma), nk,
                                 device=cuda_device)
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
