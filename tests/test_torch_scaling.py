"""nanopolish_tpu_torch scalings (MoM, WLS recalibration, 'M'-event
selection) against nanopolish_tpu.ops.scaling on the same numpy inputs.

Tolerance: rtol 1e-5 on shift/scale/drift/var.  The port sums in the
reference's compiled f32 order and solves the 2x2 and 3x3 normal
equations with the operation sequence of the host BLAS's LU, so it
agrees to the bit here; but the JAX side's LU comes from whatever BLAS
the host's scipy carries, and 1e-5 covers an f32 rounding there.  The
ok/failure flags and the 'M' masks must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nanopolish_tpu.models.pore_model import PoreModelSet
from nanopolish_tpu.ops import scaling as jsc
from nanopolish_tpu_torch.ops import scaling as tsc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return PoreModelSet.instance().get_model(
        "r9.4_450bps", "nucleotide", "template", 6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("N", [1, 17, 32, 33, 300, 1000, 5000])
def test_ordered_sum_is_the_reference_order(N):
    rng = np.random.default_rng(N)
    x = (rng.normal(100, 30, (5, N)) ** 2).astype(np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(ref, tsc.ordered_sum(_t(x)).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_mom_matches_jax(model, seed):
    rng = np.random.default_rng(seed)
    B, T, K = 6, 768, 512
    ranks = rng.integers(0, model.num_states, size=(B, K))
    lvl = model.level_mean[ranks].astype(np.float32)
    nev = np.array([700, 512, 3, 768, 1, 640], np.int32)    # degenerate reads
    nk = np.array([400, 256, 2, 512, 1, 333], np.int32)
    ev = (rng.normal(1.05, 0.01, (B, 1)) * lvl[:, np.minimum(
        np.arange(T) // 2, K - 1)] + rng.normal(3, 2, (B, T))).astype(np.float32)
    js, jc = jsc.estimate_scalings_mom(ev, jnp.asarray(nev), lvl,
                                       jnp.asarray(nk))
    ts, tc = tsc.estimate_scalings_mom(_t(ev), _t(nev), _t(lvl), _t(nk))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


@pytest.mark.parametrize("scale_drift", [False, True])
def test_recalibrate_matches_jax(model, scale_drift):
    rng = np.random.default_rng(7 + scale_drift)
    B, N = 5, 900
    ranks = rng.integers(0, model.num_states, size=(B, N))
    mu = model.level_mean[ranks].astype(np.float32)
    sd = model.level_stdv[ranks].astype(np.float32)
    t = np.sort(rng.uniform(0, 30, (B, N)), axis=1).astype(np.float32)
    lev = (1.03 * mu + 2.0 + 0.01 * t
           + rng.normal(0, 1, (B, N)) * sd).astype(np.float32)
    counts = np.array([900, 450, 199, 200, 0])      # <200: not recalibrated
    mask = np.arange(N)[None, :] < counts[:, None]
    ref = jsc.recalibrate(lev, t, mu, sd, mask, scale_var=True,
                          scale_drift=scale_drift)
    got = tsc.recalibrate(_t(lev), _t(t), _t(mu), _t(sd), _t(mask),
                          scale_var=True, scale_drift=scale_drift)
    np.testing.assert_array_equal(got.recalibrated.numpy(),
                                  np.asarray(ref.recalibrated))
    ok = np.asarray(ref.recalibrated)
    for f in ("shift", "scale", "drift", "var"):
        np.testing.assert_allclose(getattr(got, f).numpy()[ok],
                                   np.asarray(getattr(ref, f))[ok],
                                   rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("n", [2, 3])
def test_solve_is_the_host_lapack_sequence(n):
    """solve2/solve3 against jnp.linalg.solve (LAPACK getrf + trsm on the
    CPU) on well-conditioned systems whose rows come in random order, so
    that every pivot choice occurs, some of them tied; reported, and held
    to 1e-5."""
    rng = np.random.default_rng(n)
    B = 2000
    A = 4.0 * np.eye(n) + rng.normal(0, 1, (B, n, n))
    A = np.take_along_axis(A, rng.permuted(np.tile(np.arange(n), (B, 1)),
                                           axis=1)[:, :, None], axis=1)
    A = (A * 10.0 ** rng.uniform(-3, 3, (B, 1, 1))).astype(np.float32)
    A[::9, 1, 0] = A[::9, 0, 0]                     # tied pivots
    b = rng.normal(0, 100, (B, n)).astype(np.float32)
    ref = np.asarray(jnp.linalg.solve(jnp.asarray(A),
                                      jnp.asarray(b)[..., None]))[..., 0]
    got = (tsc.solve2 if n == 2 else tsc.solve3)(_t(A), _t(b)).numpy()
    n_diff = int(np.sum(np.any(got.view(np.int32) != ref.view(np.int32),
                               axis=1)))
    print(f"{n}x{n} systems not bit-identical to LAPACK: {n_diff} of {B}")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-30)


def test_mstate_events_matches_jax():
    rng = np.random.default_rng(3)
    B, K = 4, 300
    b2e = np.where(rng.random((B, K)) < 0.8,
                   np.arange(K)[None, :] * 2, -1).astype(np.int32)
    b2e[3] = -1                                     # a failed read
    ranks = rng.integers(0, 8, (B, K)).astype(np.int32)  # repeats -> 'E'
    nk = np.array([300, 250, 10, 300], np.int32)
    ref = np.asarray(jsc.mstate_events_batch(b2e, b2e, ranks, nk))
    got = tsc.mstate_events_batch(_t(b2e), _t(b2e), _t(ranks), _t(nk))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_emissions_match_jax():
    from nanopolish_tpu.ops import emissions as je
    from nanopolish_tpu_torch.ops import emissions as te
    rng = np.random.default_rng(5)
    x, mu = (rng.normal(90, 15, (2, 4000)).astype(np.float32) for _ in "ab")
    sd = rng.uniform(1, 4, 4000).astype(np.float32)
    args = (x, mu, sd, np.log(sd), np.float32(1.5), np.float32(1.02),
            np.float32(1.1), np.float32(np.log(1.1)))
    ref = np.asarray(je.log_probability_match_r9(*args))
    got = te.log_probability_match_r9(*(_t(np.asarray(a)) for a in args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    ref = np.asarray(je.z_score(x, mu, sd, 1.5, 1.02, 1.1))
    got = te.z_score(_t(x), _t(mu), _t(sd), 1.5, 1.02, 1.1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the fused form the DP fills use: one rounding of a*b + c
    a = rng.normal(0, 3, 4000).astype(np.float32)
    c = rng.normal(-1, 0.5, 4000).astype(np.float32)
    want = (a.astype(np.float64) * a + c).astype(np.float32)
    np.testing.assert_array_equal(te.fma32(_t(a), _t(a), _t(c)).numpy(), want)
