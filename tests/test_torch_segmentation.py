"""nanopolish_tpu_torch segmentation Viterbi against the JAX package.

The port's plain fill + backtrack (ops/segmentation_hmm.py, the plain
versions of csrc/seg_viterbi_fill.cu and csrc/seg_backtrack.cu) must give
the JAX scan path's labels (``_segmentation_viterbi`` +
``_backward_labels``) exactly, and the Pallas kernel's in interpret mode,
with the polya and the detect-polyi parameters; final scores within rtol
1e-5 where finite (torch's CPU exp/log are not XLA's, so the last ulp may
differ; the labels do not); the summary equal to ``_seg_summary``; and
``segment_reads`` equal to the JAX ``segment_reads`` (scan) Segmentation
for Segmentation.  Both sides get the same numpy inputs and the same
parameters: the port's ``SegmentationParams`` built by
``segmentation_params_from_dict`` from the JAX package's ``asdict``
output (it has the JAX class's fields and is hashable, so the JAX
functions take it as their static argument).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopolish_tpu.apps.detect_polyi import DPI_PARAMS as JAX_DPI
from nanopolish_tpu.ops import segmentation_hmm as jsh
from nanopolish_tpu_torch.apps.detect_polyi import DPI_PARAMS
from nanopolish_tpu_torch.ops import segmentation_hmm as sh
from nanopolish_tpu_torch.ops import segmentation_viterbi as sv
from tests import backtrack_chunks as bc

torch.set_num_threads(2)

SCALINGS = [(1.0, 0.0, 1.0), (1.02, 2.0, 1.1), (0.98, -1.5, 0.9)]


def _params(which):
    """The parameters both sides of a parity test get."""
    src = jsh.SegmentationParams() if which == "polya" else JAX_DPI
    return sh.segmentation_params_from_dict(dataclasses.asdict(src))


def _synthetic_read(rng, n_leader=300, n_adapter=200, n_polya=400,
                    n_transcript=600):
    segs = [rng.normal(70.3, 3.8, 60),            # START-ish levels
            rng.normal(110.9, 5.2, n_leader),     # LEADER
            rng.normal(63.3, 2.7, n_adapter),     # ADAPTER (a1 component)
            rng.normal(108.9, 3.3, n_polya),      # POLYA
            rng.normal(79.7, 7.0, n_transcript)]  # TRANSCRIPT (t0)
    return np.concatenate(segs).astype(np.float32)


def _case(lengths):
    """tests/test_pallas_segmentation.py's inputs: samples [B, N] padded
    with 100.0, n [B], scalings [B, 3]; reads past 1,560 samples get a
    longer transcript."""
    rng = np.random.default_rng(7)
    reads = [_synthetic_read(rng, n_transcript=max(600, n - 960))[:n]
             for n in lengths]
    B, N = len(reads), max(max(lengths), 8)
    samples = np.full((B, N), 100.0, np.float32)
    for i, r in enumerate(reads):
        samples[i, :len(r)] = r
    return samples, np.asarray(lengths, np.int32), \
        np.resize(np.asarray(SCALINGS, np.float32), (B, 3))


def _scan(samples, ns, sc, params):
    bptrs, vfin = jsh._segmentation_viterbi(
        jnp.asarray(samples), jnp.asarray(ns), jnp.asarray(sc[:, 0]),
        jnp.asarray(sc[:, 1]), jnp.asarray(sc[:, 2]), params)
    labels = np.asarray(jsh._backward_labels(bptrs, jnp.asarray(ns)))
    return labels, np.asarray(vfin)                  # [N, B], [B, 6]


def _plain(samples, ns, sc, params):
    bptr, vfin = sv.seg_viterbi_fill(torch.from_numpy(samples.T.copy()),
                                     torch.from_numpy(ns),
                                     torch.from_numpy(sc),
                                     sh.seg_constants(params))
    summ, labels = sv.seg_backtrack(bptr, torch.from_numpy(ns), labels=True)
    return bptr.numpy(), vfin.numpy(), summ.numpy(), labels.numpy()


CASES = [pytest.param(lengths, which, id=f"{len(lengths)}reads-{which}")
         for lengths in ((1560,), (1560, 900, 1233))
         for which in ("polya", "dpi")]


def test_params_are_the_jax_packages():
    assert dataclasses.asdict(sh.SegmentationParams()) == \
        dataclasses.asdict(jsh.SegmentationParams())
    assert dataclasses.asdict(DPI_PARAMS) == dataclasses.asdict(JAX_DPI)
    for src in (jsh.SegmentationParams(), JAX_DPI):
        got = sh.segmentation_params_from_dict(dataclasses.asdict(src))
        assert dataclasses.asdict(got) == dataclasses.asdict(src)
        hash(got)                                    # stays hashable


@pytest.mark.parametrize("lengths,which", CASES)
def test_plain_matches_jax_scan(lengths, which):
    p = _params(which)
    samples, ns, sc = _case(lengths)
    want, _ = _scan(samples, ns, sc, p)
    _, vfin, _, got = _plain(samples, ns, sc, p)
    # every row: past each read's length both hold T
    np.testing.assert_array_equal(got, want)
    # final scores: the scan's after each read's own last sample
    for b, n in enumerate(ns):
        _, ref = _scan(samples[b:b + 1, :n], ns[b:b + 1], sc[b:b + 1], p)
        fin = np.isfinite(ref[0])
        np.testing.assert_array_equal(fin, np.isfinite(vfin[b]))
        np.testing.assert_allclose(vfin[b][fin], ref[0][fin], rtol=1e-5)


@pytest.mark.parametrize("lengths,which", CASES)
def test_plain_matches_pallas_interpret(lengths, which):
    from nanopolish_tpu.ops.pallas_segmentation import \
        segmentation_labels_pallas
    p = _params(which)
    samples, ns, sc = _case(lengths)
    want = segmentation_labels_pallas(samples, ns, sc[:, 0], sc[:, 1],
                                      sc[:, 2], params=p, interpret=True)
    _, _, _, got = _plain(samples, ns, sc, p)
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(got[:n, b], want[b, :n])


@pytest.mark.parametrize("lengths,which", CASES)
def test_summary_matches_jax_seg_summary(lengths, which):
    from nanopolish_tpu.ops.pallas_segmentation import _seg_summary
    p = _params(which)
    samples, ns, sc = _case(lengths)
    labels, _ = _scan(samples, ns, sc, p)
    want = np.asarray(_seg_summary(
        jnp.asarray(np.broadcast_to(labels[:, None, :],
                                    (labels.shape[0], 8, labels.shape[1]))),
        jnp.asarray(ns)))
    _, _, got, _ = _plain(samples, ns, sc, p)
    np.testing.assert_array_equal(got, want)
    # and each summary row gives _extract_segmentation's Segmentation
    for b, n in enumerate(ns):
        assert sh.segmentation_from_summary(got[b], int(n)) == \
            tuple(jsh._extract_segmentation(labels[:n, b]))


def _corpus(seed, n_reads, lo, hi, parts):
    """tests/test_segmentation.py's corpora."""
    rng = np.random.default_rng(seed)
    samples_list, scalings = [], []
    for _ in range(n_reads):
        n = int(rng.integers(lo, hi))
        (a, b, c, e) = parts
        s = np.concatenate([
            rng.normal(70, 3, a), rng.normal(110, 5, b),
            rng.normal(75, 6, c), rng.normal(108, 3, n),
            rng.normal(90, 12, e)]).astype(np.float32)
        samples_list.append(s)
        scalings.append((1.0, 0.0, 1.0))
    return samples_list, scalings


CORPORA = {"5reads": (3, 5, 400, 3000, (60, 150, 200, 400)),
           "131reads": (7, 131, 80, 400, (40, 60, 80, 100))}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_segment_reads_matches_jax(corpus, monkeypatch):
    samples_list, scalings = _corpus(*CORPORA[corpus])
    monkeypatch.setenv("NPT_SEG_IMPL", "scan")
    want = jsh.segment_reads(samples_list, scalings)
    got = sh.segment_reads(samples_list, scalings, device="cpu")
    assert [tuple(g) for g in got] == [tuple(w) for w in want]


def test_byte_cap_splits_the_batch(monkeypatch):
    samples_list, scalings = _corpus(*CORPORA["5reads"])
    lens = np.sort([len(s) for s in samples_list])[::-1]
    cap = int(lens[0]) * 2
    plan = sh.plan_launches(lens, cap)
    assert len(plan) >= 3
    assert all(N * (hi - lo) <= cap for lo, hi, N in plan)
    assert [p[0] for p in plan][1:] == [p[1] for p in plan][:-1]
    whole = sh.segment_reads(samples_list, scalings, device="cpu")
    monkeypatch.setattr(sh, "BPTR_CAP_BYTES", cap)
    split = sh.segment_reads(samples_list, scalings, device="cpu")
    assert split == whole
    # one read longer than the cap still gets a launch of its own
    assert sh.plan_launches(np.array([50, 10]), 20) == [(0, 1, 50),
                                                        (1, 2, 10)]


def test_extract_segmentation_matches_jax():
    """The label-array variant and the summary helper give the JAX
    package's Segmentation, the defaulting quirk included."""
    rng = np.random.default_rng(5)
    cases = [np.array([0, 0, 1, 1, 2, 2, 3, 3, 5, 5], np.uint8),
             np.array([0, 1, 2, 3, 4, 3, 5], np.uint8),     # index 1/2/3
             np.full(12, 3, np.uint8),                        # no transition
             np.array([5], np.uint8)]
    cases += [np.sort(rng.integers(0, 6, int(rng.integers(2, 40)))
                      ).astype(np.uint8) for _ in range(40)]
    for lab in cases:
        assert sh._extract_segmentation(lab) == \
            tuple(jsh._extract_segmentation(lab))


def test_segment_reads_rejects_empty_reads():
    with pytest.raises(ValueError):
        sh.segment_reads([np.zeros(0, np.float32)], [(1.0, 0.0, 1.0)],
                         device="cpu")
    assert sh.segment_reads([], [], device="cpu") == []


def test_backpointer_bytes_follow_the_kernel_layout():
    """Row 0 and the rows past each read's length are 0 (the kernel's
    zeroed output); live bytes use bits 0-5 only, P's code 0-2; and the
    bytes decode to the JAX scan's backpointers."""
    p = _params("polya")
    samples, ns, sc = _case((1560, 900, 1233))
    bptr, _, _, _ = _plain(samples, ns, sc, p)
    assert not bptr[0].any()
    for b, n in enumerate(ns):
        assert not bptr[n:, b].any()
    assert not (bptr & 0xC0).any() and ((bptr >> 2) & 3).max() <= 2
    jb, _ = jsh._segmentation_viterbi(
        jnp.asarray(samples), jnp.asarray(ns), jnp.asarray(sc[:, 0]),
        jnp.asarray(sc[:, 1]), jnp.asarray(sc[:, 2]), p)
    jb = np.asarray(jb)                              # [N, B, 6]
    dec = sh._decode_table(torch.device("cpu")).numpy()[bptr & 63]
    for b, n in enumerate(ns):
        np.testing.assert_array_equal(dec[1:n, b], jb[1:n, b])


def test_every_kernel_has_its_source_and_c_signature():
    import os

    from nanopolish_tpu_torch.utils import cuda_build
    assert set(cuda_build._ARGTYPES) == set(cuda_build.KERNELS)
    assert {"seg_viterbi_fill", "seg_backtrack"} <= set(cuda_build.KERNELS)
    for name in cuda_build.KERNELS:
        src = os.path.join(cuda_build.CSRC_DIR, f"{name}.cu")
        assert f"npt_launch_{name}(" in open(src).read()


def _kernel_source(name):
    import os
    return open(os.path.join(os.path.dirname(sv.__file__), "..", "csrc",
                             f"{name}.cu")).read()


def test_scan_constants_match_kernel():
    """The model's block, group and map layout are the kernel's."""
    src = _kernel_source("seg_backtrack")
    assert f"constexpr int THREADS = {bc.THREADS};" in src
    assert f"constexpr int SPT = {bc.SPT};" in src
    assert "return (int)((m >> x5) & 31u);" in src      # 5-bit fields
    ident = "(0u << 0) | (5u << 5) | (10u << 10) | (15u << 15) |"
    assert ident in src and bc.IDENT == sum(5 * s << 5 * s for s in range(6))


def test_map_table_matches_decode_table():
    """Every field of the 64 byte maps is _decode_table's predecessor (all
    64 x 6), and composing maps is applying them in turn (associative)."""
    tab = bc.map_table()
    dec = sh._decode_table(torch.device("cpu")).numpy()
    for byte in range(64):
        for s in range(6):
            assert bc.apply(int(tab[byte]), 5 * s) == 5 * int(dec[byte, s])
    rng = np.random.default_rng(0)
    a, b, c = (tab[rng.integers(0, 64, 200)] for _ in range(3))
    np.testing.assert_array_equal(bc.compose(bc.compose(a, b), c),
                                  bc.compose(a, bc.compose(b, c)))
    for s in range(6):
        np.testing.assert_array_equal(bc.apply(bc.compose(a, b), 5 * s),
                                      bc.apply(b, bc.apply(a, 5 * s)))


def _decoded(bptr):
    """[N, B, 6] predecessors of [N, B] bytes, the JAX scan's layout."""
    return sh._decode_table(torch.device("cpu")).numpy()[bptr & 63]


# n = 1, 2, 3; reads shorter than a thread's 16-byte group; walks of one
# tile (THREADS x SPT samples) less one, one and one more; all but the
# longest read of a batch are shorter than its padded length
SCAN_LENGTHS = {"1-3": (1, 2, 3), "short": (17, 5, 12),
                "tile": (4097, 4098, 4099, 4100)}


@pytest.mark.parametrize("which", ["polya", "dpi"])
@pytest.mark.parametrize("lengths", sorted(SCAN_LENGTHS))
def test_scan_model_matches_plain_and_jax(lengths, which):
    """The model of the kernel's map scan on the plain fill's backpointers
    gives seg_backtrack_plain's labels and summary exactly, and the JAX
    _backward_labels and _seg_summary on the same bytes."""
    from nanopolish_tpu.ops.pallas_segmentation import _seg_summary
    samples, ns, sc = _case(SCAN_LENGTHS[lengths])
    bptr, _, want_summ, want_lab = _plain(samples, ns, sc, _params(which))
    got_summ, got_lab = bc.scan_backtrack(bptr, ns)
    np.testing.assert_array_equal(got_lab, want_lab)
    np.testing.assert_array_equal(got_summ, want_summ)
    jlab = np.asarray(jsh._backward_labels(jnp.asarray(_decoded(bptr)),
                                           jnp.asarray(ns)))
    np.testing.assert_array_equal(got_lab, jlab)
    jsum = np.asarray(_seg_summary(
        jnp.asarray(np.broadcast_to(jlab[:, None, :],
                                    (jlab.shape[0], 8, jlab.shape[1]))),
        jnp.asarray(ns)))
    np.testing.assert_array_equal(got_summ, jsum)


def _random_backpointers(rng, N, B):
    """Bytes that keep each state for a while and reach every state (the
    stay bits set with probability 0.97, P's code 0 with 0.9), with random
    bits 6-7 that the decode ignores."""
    stay = rng.random((N, B, 4)) < 0.97
    code = rng.choice(4, size=(N, B), p=[0.9, 0.05, 0.03, 0.02])
    return (stay[..., 0] | stay[..., 1] << 1 | code << 2 | stay[..., 2] << 4
            | stay[..., 3] << 5 | rng.integers(0, 4, (N, B)) << 6
            ).astype(np.uint8)


@pytest.mark.parametrize("align", [0, 1, 7, 15])
def test_scan_model_random_bytes_any_alignment(align):
    """On random bytes, with each read's row starting at any offset in its
    16-byte group, the model gives seg_backtrack_plain's labels and
    summary, every transition and cliffs included."""
    rng = np.random.default_rng(align)
    N, B = 4111, 12
    ns = np.array([1, 2, 3, 4, 17, 18, 4095, 4096, 4097, 4098, N - 1, N],
                  np.int32)
    bptr = _random_backpointers(rng, N, B)
    want_summ, want_lab = sh.seg_backtrack_plain(torch.from_numpy(bptr),
                                                 torch.from_numpy(ns))
    got_summ, got_lab = bc.scan_backtrack(bptr, ns, aligns=[align] * B)
    np.testing.assert_array_equal(got_lab, want_lab.numpy())
    np.testing.assert_array_equal(got_summ, want_summ.numpy())
    assert (got_summ[:, :4] >= 0).sum() >= 20 and got_summ[:, 4].sum() > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA segmentation kernels have "
                    "no CPU mode (their plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["polya", "dpi"])
@pytest.mark.parametrize("lengths", [(1560, 900, 1233),
                                     (1, 2, 31, 32, 33, 64, 65, 1500),
                                     (1, 2, 3, 4097, 4098, 4099, 4100),
                                     (65600, 2000)])
def test_kernels_match_plain_on_gpu(cuda_device, which, lengths):
    """The fill's warp per read, 32 samples a chunk: reads that end
    inside, at and just past a chunk, and the read-major bytes the fill
    hands to the backtrack; the backtrack's block per read: n = 1-3,
    walks of one tile less one, one and one more, and a read of 65,600
    samples (17 tiles)."""
    samples, ns, sc = _case(lengths)
    x = torch.from_numpy(samples.T.copy()).to(cuda_device)
    n = torch.from_numpy(ns).to(cuda_device)
    s = torch.from_numpy(sc).to(cuda_device)
    k = sh.seg_constants(_params(which))
    bk, vk = sv.seg_viterbi_fill(x, n, s, k)
    bp, vp = sh.seg_viterbi_fill_plain(x, n, s, k)
    assert torch.equal(bk, bp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    sk, lk = sv.seg_backtrack(bk, n, labels=True)
    sp, lp = sh.seg_backtrack_plain(bp, n)
    assert torch.equal(sk, sp) and torch.equal(lk, lp)
