"""nanopolish_tpu_torch's indexed Forward (ops/profile_hmm_indexed.py, the
plain version of csrc/forward_indexed.cu) against the JAX package.

The same numpy-built indexed inputs (unique event rows, per-read tables,
unique kmer-rank rows, transition rows, four ids per segment) go to the
JAX drain ``forward_packed`` (its Pallas kernel in interpret mode, as
tests/test_forward_indexed.py runs it), to the JAX scan and to the port.
The bar against JAX is ROADMAP's tolerance where outputs are not bit for
bit: atol 2e-3 nats (XLA's exp/log1p are its own polynomials; the Pallas
body's max-shifted sums are other arithmetic).  Both sides get the same
transition table.  Within the port the indexed drain must equal the flat
Forward (``forward_fill_plain`` on the gathered inputs) bit for bit,
whatever its launch's Tc, Kc, width group or batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopolish_tpu.ops.pallas_profile_hmm import forward_packed
from nanopolish_tpu.ops.profile_hmm import (BlockTransitions,
                                            profile_hmm_forward)
from nanopolish_tpu_torch.models.pore_model import PoreModelSet
from nanopolish_tpu_torch.ops import profile_hmm as ph
from nanopolish_tpu_torch.ops import profile_hmm_forward as pf
from nanopolish_tpu_torch.ops import profile_hmm_indexed as pi
from nanopolish_tpu_torch.ops.banded_align import emission_constant

torch.set_num_threads(2)

ATOL = 2e-3
FLAGS = ph.HAF_ALLOW_PRE_CLIP | ph.HAF_ALLOW_POST_CLIP


def _case(seed, widths, n=48, E=6, R=3, reversed_rows=True):
    """Screening-shaped indexed inputs: E event rows drawn along a random
    window of the model (some stored reversed, as a read on the other
    strand walks its events backwards), per-read tables of the 6-mer model
    under random scalings, rank rows of the given widths and ~8 segments
    per event row."""
    model = PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)
    rng = np.random.default_rng(seed)
    S = model.num_states
    shift = rng.uniform(-2, 2, R)
    scale = rng.uniform(0.95, 1.05, R)
    var = rng.uniform(0.9, 1.3, R)
    mu = (scale[:, None] * model.level_mean[None] + shift[:, None]
          ).astype(np.float32)
    sig = (model.level_stdv[None] * var[:, None]).astype(np.float32)
    n_km_u = np.asarray(widths, np.int32)
    U, Kc = len(n_km_u), int(n_km_u.max())
    rank_mat = np.zeros((U, Kc), np.int32)
    for u, w in enumerate(n_km_u):
        rank_mat[u, :w] = rng.integers(0, S, w)
    n_ev_u = rng.integers(np.maximum(n_km_u.min(), 2), 2 * Kc + 20,
                          E).astype(np.int32)
    Tc = int(n_ev_u.max())
    levels_u = np.zeros((E, Tc), np.float32)
    for e in range(E):
        u = rng.integers(0, U)
        w, t = int(n_km_u[u]), int(n_ev_u[e])
        reps = np.minimum((np.arange(t) * w / t).astype(int), w - 1)
        ks = rank_mat[u, reps]
        row = mu[0, ks] + rng.normal(0, 1, t) * sig[0, ks]
        levels_u[e, :t] = row[::-1] if reversed_rows and e % 2 else row
    epb = rng.uniform(1.6, 2.4, R).astype(np.float32)
    trans_u = ph.make_transitions(epb, 0.9)
    ids = np.stack([np.repeat(np.arange(E), -(-n // E))[:n],
                    rng.integers(0, R, n), rng.integers(0, U, n),
                    rng.integers(0, R, n)], axis=1).astype(np.int32)
    return dict(levels_u=levels_u, n_ev_u=n_ev_u, mu=mu, sig=sig,
                rank_mat=rank_mat, n_km_u=n_km_u, trans_u=trans_u, ids=ids,
                epb=epb)


def _tabs(c):
    """The port's [3, R, S] tables: mu, sigma, c = emission_constant."""
    return np.stack([c["mu"], c["sig"], emission_constant(np.log(c["sig"]))])


def _indexed(c):
    return (c["levels_u"], c["n_ev_u"], _tabs(c), c["rank_mat"],
            c["n_km_u"], c["trans_u"], c["ids"])


def _port(c, flags=FLAGS):
    return pi.forward_indexed_scores(*_indexed(c), flags, device="cpu")


def _flat(c):
    """Per-segment padded matrices gathered on the host."""
    ids = c["ids"]
    nk = c["n_km_u"][ids[:, 2]]
    Kc = c["rank_mat"].shape[1]
    mu = np.zeros((len(ids), Kc), np.float32)
    sd = np.ones((len(ids), Kc), np.float32)
    for i, (e, t, u, x) in enumerate(ids):
        rk = c["rank_mat"][u, :nk[i]]
        mu[i, :nk[i]] = c["mu"][t, rk]
        sd[i, :nk[i]] = c["sig"][t, rk]
    return (c["levels_u"][ids[:, 0]], c["n_ev_u"][ids[:, 0]], mu, sd, nk,
            c["trans_u"][ids[:, 3]])


def _report(got, ref, name):
    d = np.abs(got.astype(np.float64) - np.asarray(ref, np.float64))
    print(f"{name}: max |port - JAX| = {d.max():.3g} nats over {len(d)} "
          f"segments, {np.mean(got == ref):.0%} bit-identical")


WIDTHS = {
    "screening": [16, 17, 15, 16, 12, 16, 11, 16],
    "mixed_1_to_32": [1, 2, 5, 8, 16, 17, 24, 31, 32],
    "mixed_wide": [1, 16, 33, 64, 100, 150],
}


@pytest.mark.parametrize("shape", sorted(WIDTHS))
def test_plain_matches_jax_forward_packed(shape):
    c = _case(3, WIDTHS[shape])
    got = _port(c)
    jtabs = np.stack([c["mu"], c["sig"], np.log(c["sig"])])
    want = np.asarray(forward_packed(c["levels_u"], c["n_ev_u"], jtabs,
                                     c["rank_mat"], c["n_km_u"],
                                     c["trans_u"], c["ids"],
                                     np.full(len(c["ids"]), FLAGS,
                                             np.int32)))
    _report(got, want, f"forward_packed (interpret), {shape}")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", sorted(WIDTHS))
@pytest.mark.parametrize("flags", [0, 3])
def test_plain_matches_jax_scan(shape, flags):
    c = _case(5 + flags, WIDTHS[shape])
    lv, nev, mu, sd, nk, trans = _flat(c)
    cols = (0, 1, 2, 3, 4, 5, 5, 5, 6, 7)   # BlockTransitions field order
    jt = BlockTransitions(*[jnp.asarray(trans[:, i]) for i in cols])
    want = np.asarray(profile_hmm_forward(lv, nev, mu, sd, np.log(sd), nk,
                                          np.ones(len(nk), np.float32),
                                          flags=flags, trans=jt))
    got = _port(c, flags)
    _report(got, want, f"scan, {shape}, flags {flags}")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", sorted(WIDTHS))
def test_indexed_equals_flat_forward_bit_for_bit(shape):
    """The indexed drain equals the flat Forward (prepare_viterbi_inputs +
    forward_fill_plain) on the gathered inputs, bit for bit."""
    c = _case(9, WIDTHS[shape])
    lv, nev, mu, sd, nk, trans = _flat(c)
    flat = pf.profile_hmm_forward(lv, nev, mu, sd, nk, None, FLAGS,
                                  trans=trans, device="cpu")
    got = _port(c)
    np.testing.assert_array_equal(got.view(np.int32), flat.view(np.int32))
    direct = ph.forward_indexed_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in _indexed(c)],
        torch.full((len(c["ids"]), 2), 1, dtype=torch.uint8)).numpy()
    np.testing.assert_array_equal(direct.view(np.int32), got.view(np.int32))


def test_scores_do_not_depend_on_padding_or_batch():
    """Padding Tc and Kc, other rows beside a segment, or scoring it alone
    change no score (compare tests/test_torch_forward.py's padding test)."""
    c = _case(11, WIDTHS["mixed_wide"])
    base = _port(c)
    p = dict(c)
    p["levels_u"] = np.pad(c["levels_u"], ((0, 3), (0, 77)), constant_values=7)
    p["n_ev_u"] = np.concatenate([c["n_ev_u"], [5, 9, 3]]).astype(np.int32)
    p["rank_mat"] = np.pad(c["rank_mat"], ((0, 2), (0, 41)))
    p["n_km_u"] = np.concatenate([c["n_km_u"], [3, 40]]).astype(np.int32)
    padded = _port(p)
    np.testing.assert_array_equal(padded.view(np.int32), base.view(np.int32))
    for i in (0, 7, len(base) - 1):
        one = dict(c, ids=c["ids"][i:i + 1])
        assert _port(one)[0] == base[i]


def test_flags_and_empty_segments():
    c = _case(13, WIDTHS["screening"])
    flags = (np.arange(len(c["ids"])) % 4).astype(np.int32)
    mixed = _port(c, flags)
    for f in range(4):
        sel = flags == f
        alone = _port(dict(c, ids=c["ids"][sel]), f)
        np.testing.assert_array_equal(mixed[sel], alone)
    z = dict(c, n_ev_u=np.where(np.arange(len(c["n_ev_u"])) == 0, 0,
                                c["n_ev_u"]).astype(np.int32))
    got = _port(z)
    first = c["ids"][:, 0] == 0
    assert np.all(got[first] == -np.inf) and np.isfinite(got[~first]).all()


def test_bad_inputs_raise():
    c = _case(15, WIDTHS["screening"])
    bad = dict(c, ids=c["ids"].copy())
    bad["ids"][3, 2] = len(c["n_km_u"])
    with pytest.raises(ValueError, match="rank ids"):
        _port(bad)
    wide = dict(c, n_km_u=c["n_km_u"] + 1)
    with pytest.raises(ValueError, match="Kc"):
        _port(wide)
    with pytest.raises(ValueError, match="power of two"):
        pi.indexed_layout(48)
    # a rank row past 1,024 kmers is no bad input: it scores
    got = pi.forward_indexed_scores(
        c["levels_u"], c["n_ev_u"], _tabs(c),
        np.zeros((1, 1025), np.int32), np.array([1025], np.int32),
        c["trans_u"], np.zeros((1, 4), np.int32), FLAGS, device="cpu")
    assert np.isfinite(got).all()


def _short(c, t_max):
    """c with every event row cut to at most t_max levels."""
    return dict(c, n_ev_u=np.minimum(c["n_ev_u"], t_max).astype(np.int32),
                levels_u=c["levels_u"][:, :t_max].copy())


def test_wide_windows_match_jax_scan():
    """Windows of 1,100 and 3,000 kmers among short ones (the wide row on
    the card, 2,048 and 4,096 kmers a segment) score as the JAX scan
    scores their flat inputs, and as the port's flat Forward bit for
    bit."""
    c = _short(_case(19, [1100, 3000, 20, 7], n=8, E=2), 90)
    lv, nev, mu, sd, nk, trans = _flat(c)
    cols = (0, 1, 2, 3, 4, 5, 5, 5, 6, 7)   # BlockTransitions field order
    jt = BlockTransitions(*[jnp.asarray(trans[:, i]) for i in cols])
    want = np.asarray(profile_hmm_forward(lv, nev, mu, sd, np.log(sd), nk,
                                          np.ones(len(nk), np.float32),
                                          flags=FLAGS, trans=jt))
    got = _port(c)
    _report(got, want, "scan, wide windows")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    flat = pf.profile_hmm_forward(lv, nev, mu, sd, nk, None, FLAGS,
                                  trans=trans, device="cpu")
    np.testing.assert_array_equal(got.view(np.int32), flat.view(np.int32))


@pytest.mark.parametrize("kp,layout", [
    (8, ("narrow", 1)), (16, ("narrow", 1)), (32, ("narrow", 1)),
    (64, ("warp", 2)), (128, ("warp", 4)), (256, ("block", 0)),
    (512, ("block", 0)), (1024, ("block", 0)),
    (2048, ("wide", None)), (65536, ("wide", None))])
def test_indexed_layout(kp, layout):
    """Past 1,024 kmers the wide row, whose geometry also depends on the
    launch's segment count (profile_hmm_viterbi.wide_layout)."""
    assert pi.indexed_layout(kp) == layout
    assert pi.indexed_width(kp) == kp and pi.indexed_width(kp - 1) == kp


@pytest.mark.parametrize("kp,n", [(2048, 8), (2048, 200), (65536, 3)])
def test_indexed_wide_launch_geometry(monkeypatch, kp, n):
    """A wide launch of n segments hands the kernel wide_layout's kmers a
    thread, threads a CTA and CTAs a segment for the Forward's rows, and
    a scratch buffer exactly when those rows are in scratch."""
    from nanopolish_tpu_torch.ops import profile_hmm_viterbi as pv
    from nanopolish_tpu_torch.utils import cuda_build
    calls, scratches = [], []
    monkeypatch.setattr(cuda_build, "require_cuda", lambda t: None)
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(cuda_build, "count_launch", lambda name: None)
    monkeypatch.setattr(pi, "card_sms", lambda dev: 132)
    wide_scratch = pi.wide_scratch
    monkeypatch.setattr(pi, "wide_scratch", lambda lay, m, dev: scratches.
                        append(wide_scratch(lay, m, dev)) or scratches[-1])
    meta = torch.device("meta")
    f32, i32 = torch.float32, torch.int32
    E, Tc, R, S, U = 2, 9, 1, 4096, 2
    pi.forward_indexed(
        torch.empty((E, Tc), dtype=f32, device=meta),
        torch.empty(E, dtype=i32, device=meta),
        torch.empty((3, R, S), dtype=f32, device=meta),
        torch.empty((U, kp), dtype=i32, device=meta),
        torch.empty(U, dtype=i32, device=meta),
        torch.empty((1, 8), dtype=f32, device=meta),
        torch.empty((n, 4), dtype=i32, device=meta),
        torch.empty((n, 2), dtype=torch.uint8, device=meta), kp=kp)
    (name, a), = calls
    lay = pv.wide_layout(kp, n, False)
    assert name == "forward_indexed" and a[16] == kp
    assert a[17:21] == (lay.per_thread, lay.threads, lay.cluster, n)
    (scratch,) = scratches
    assert (scratch is None) == (lay.rows == "shared")
    if scratch is not None:
        assert scratch.numel() == n * lay.scratch


def test_plan_flush_shares_one_launch_below_33_kmers():
    """Windows of 1-32 kmers go in one launch, each at its own kmer width
    (8, 16, 32), longest event row first within a width; each wider width
    gets launches of its own."""
    nk = np.array([5, 40, 17, 9, 300, 32, 1, 2000, 64, 16])
    nev = np.arange(10, 20)
    order, launches = pi.plan_flush(nev, nk)
    assert [(kp, hi - lo) for kp, lo, hi, _ in launches] == \
        [(32, 6), (64, 2), (512, 1), (2048, 1)]
    kp, lo, hi, widths = launches[0]
    assert widths.tolist() == [8, 8, 16, 16, 32, 32]
    assert nk[order[:2]].tolist() == [1, 5]     # longest event row first
    # the kernel's run ends: [0, 2) 8 kmers wide, [2, 4) 16, [4, 6) 32
    assert pi.narrow_runs(widths) == (2, 4)
    assert pi.narrow_runs([32, 32]) == (0, 0)
    with pytest.raises(ValueError, match="in order"):
        pi.narrow_runs([16, 8])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA indexed Forward kernel has "
                    "no CPU mode (its plain version is tested above)")
    return torch.device("cuda")


GPU_WIDTHS = dict(WIDTHS, calling=[64, 100, 128, 200, 256],
                  block=[300, 512, 700, 1024], wide=[1100, 20, 3000])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GPU_WIDTHS))
def test_kernel_matches_plain_and_forward_fill_on_gpu(cuda_device, shape):
    """Every mode of indexed_layout (kmer widths 8, 16, 32 mixed in one
    launch, the warp row at 64/128, the block row at 256-1,024, the wide
    row), bit for bit against the plain version and the flat forward_fill
    kernel."""
    c = _case(17, GPU_WIDTHS[shape], n=512 if shape != "wide" else 16)
    if shape in ("block", "wide"):
        c = _short(c, 120)
    got = pi.forward_indexed_scores(*_indexed(c), FLAGS, device=cuda_device)
    plain = _port(c)
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    lv, nev, mu, sd, nk, trans = _flat(c)
    flat = pf.profile_hmm_forward(lv, nev, mu, sd, nk, None, FLAGS,
                                  trans=trans, device=cuda_device)
    np.testing.assert_array_equal(got.view(np.int32), flat.view(np.int32))


@pytest.mark.cuda
def test_grouping_does_not_change_scores_on_gpu(cuda_device):
    """Windows of 1-32 kmers give the same bits in one mixed launch (four
    to a warp, beside windows of other widths and event counts) as each
    alone in a launch of its own."""
    c = _case(21, list(range(1, 33)), n=96)
    mixed = pi.forward_indexed_scores(*_indexed(c), FLAGS,
                                      device=cuda_device)
    for i in range(len(mixed)):
        one = dict(c, ids=c["ids"][i:i + 1])
        alone = pi.forward_indexed_scores(*_indexed(one), FLAGS,
                                          device=cuda_device)
        assert alone.view(np.int32)[0] == mixed.view(np.int32)[i], i
