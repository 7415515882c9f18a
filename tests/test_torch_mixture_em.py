"""nanopolish_tpu_torch's batched mixture EMs (ops/mixture_em.py) against
the JAX package's, and the recovery tests of tests/test_mixture_em.py on
the port.

The tolerance.  The JAX package's EM runs in f32 with XLA's exp and log,
which on the CPU are its own polynomials; the port's runs in f64 and
rounds its results to f32, so the difference is the JAX program's own f32
error, which ten EM iterations over two-component mixtures carry along.
The largest differences measured on the inputs below (R = 64 kmers,
N = 200 events, C = 2, masked tails, disabled second components, a
one-event kmer; seeds 0-2) were 3.8e-5 pA on a mean, 1.9e-5 relative on a
stdv and 2.1e-5 on a log weight, and of the inverse-Gaussian EM (seeds
0-1) 1.1e-6 relative on eta or sd_stdv; the tolerances are about 3x, 5x,
5x and 9x those.  Each case prints its own maxima.
"""

import numpy as np
import pytest
import torch

from nanopolish_tpu_torch.ops import mixture_em as em

torch.set_num_threads(2)

MEAN_ATOL = 1e-4       # pA
STDV_RTOL = 1e-4
LOGW_ATOL = 1e-4
ETA_RTOL = 1e-5


def gaussian_inputs(seed, R=64, N=200):
    """Seeded EM inputs shaped like methyltrain's: a kmer with one event,
    one with all N, the rest with masked tails; every third kmer has its
    second component disabled; 10% of events from a component 4 pA
    lower."""
    rng = np.random.default_rng(seed)
    mu_t = rng.uniform(60, 120, R)
    n = rng.integers(1, N + 1, R)
    n[0], n[1] = 1, N
    mask = np.arange(N)[None, :] < n[:, None]
    low = rng.random((R, N)) < 0.1
    svar = rng.uniform(0.9, 1.2, (R, N)).astype(np.float32)
    levels = (mu_t[:, None] + np.where(low, -4.0, 0.0)
              + rng.normal(0, 2.0, (R, N)) * svar).astype(np.float32)
    levels[~mask] = 1.0
    svar[~mask] = 1.0
    logw = np.tile(np.log([0.95, 0.05]).astype(np.float32), (R, 1))
    logw[::3] = (0.0, -np.inf)
    mu0 = np.stack([mu_t + 3.0, mu_t - 4.0], 1).astype(np.float32)
    sd0 = np.tile(np.array([2.0, 2.5], np.float32), (R, 1))
    return levels, svar, mask, logw, mu0, sd0


def invgauss_inputs(seed, R=64, N=200):
    """gaussian_inputs plus event stdvs and var_sd ratios, and IG noise
    parameters (eta 1.0-2.0, lambda 20-30)."""
    rng = np.random.default_rng(seed + 100)
    levels, svar, mask, logw, mu0, sd0 = gaussian_inputs(seed, R, N)
    stdvs = rng.uniform(0.8, 2.5, (R, N)).astype(np.float32)
    ratio = rng.uniform(0.8, 1.25, (R, N)).astype(np.float32)
    stdvs[~mask] = 1.0
    ratio[~mask] = 1.0
    eta0 = rng.uniform(1.0, 2.0, (R, 2)).astype(np.float32)
    lam0 = rng.uniform(20.0, 30.0, (R, 2)).astype(np.float32)
    return levels, stdvs, svar, ratio, mask, logw, mu0, sd0, eta0, lam0


def _maxdiff(got, want, rel=False):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    d = np.abs(got[fin].astype(np.float64) - want[fin])
    return float((d / np.abs(want[fin])).max() if rel else d.max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_em_matches_jax(seed):
    from nanopolish_tpu.ops.mixture_em import \
        train_gaussian_mixture_batched as jax_em
    x = gaussian_inputs(seed)
    want = jax_em(*x)
    got = em.train_gaussian_mixture_batched(*x, device="cpu")
    dm = _maxdiff(got.means, want.means)
    ds = _maxdiff(got.stdvs, want.stdvs, rel=True)
    dw = _maxdiff(got.log_weights, want.log_weights)
    print(f"gaussian EM seed {seed}: max |d mean| {dm:.3g} pA, max rel "
          f"d stdv {ds:.3g}, max |d log weight| {dw:.3g}")
    assert dm <= MEAN_ATOL and ds <= STDV_RTOL and dw <= LOGW_ATOL
    # disabled components keep their parameters, exactly
    off = ~np.isfinite(x[3])
    assert np.isneginf(got.log_weights.numpy()[off]).all()
    np.testing.assert_array_equal(got.means.numpy()[off], x[4][off])
    np.testing.assert_array_equal(got.stdvs.numpy()[off], x[5][off])


@pytest.mark.parametrize("seed", [0, 1])
def test_invgauss_em_matches_jax(seed):
    from nanopolish_tpu.ops.mixture_em import \
        train_invgaussian_mixture_batched as jax_ig
    x = invgauss_inputs(seed)
    want = jax_ig(*x)
    got = em.train_invgaussian_mixture_batched(*x, device="cpu")
    de = _maxdiff(got.sd_means, want.sd_means, rel=True)
    dsd = _maxdiff(got.sd_stdvs, want.sd_stdvs, rel=True)
    print(f"inverse-gaussian EM seed {seed}: max rel d eta {de:.3g}, "
          f"max rel d sd_stdv {dsd:.3g}")
    assert de <= ETA_RTOL and dsd <= ETA_RTOL
    np.testing.assert_array_equal(got.sd_lambdas.numpy(), x[9])


@pytest.mark.parametrize("fn", ["gaussian", "invgauss"])
def test_padded_lanes_never_reach_a_sum(fn):
    """NaN and inf in masked lanes change nothing."""
    if fn == "gaussian":
        x = list(gaussian_inputs(0, R=8, N=32))
        run = em.train_gaussian_mixture_batched
        per_event, mask_at = (0, 1), 2
    else:
        x = list(invgauss_inputs(0, R=8, N=32))
        run = em.train_invgaussian_mixture_batched
        per_event, mask_at = (0, 1, 2, 3), 4
    clean = run(*x, device="cpu")
    for i, bad in zip(per_event, (np.nan, np.inf, 0.0, -np.inf)):
        x[i] = np.where(x[mask_at], x[i], np.float32(bad))
    dirty = run(*x, device="cpu")
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["two_components", "independent_kmers"])
def test_gaussian_em_recovers(case):
    """tests/test_mixture_em.py's Gaussian recoveries on the port (the
    behaviour spec of src/test/nanopolish_test.cpp:457-574): a known
    2-component mixture with per-read variance scaling, weights and means
    within 5%; and two single-component kmers trained together stay
    independent."""
    if case == "two_components":
        rng = np.random.default_rng(17)
        n = 1000
        comp = rng.choice(2, size=n, p=[0.6, 0.4])
        read_var = rng.uniform(0.9, 1.2, size=n)
        levels = rng.normal(np.take([80.0, 95.0], comp),
                            np.take([2.0, 3.0], comp) * read_var
                            ).astype(np.float32)
        fit = em.train_gaussian_mixture_batched(
            levels[None, :], read_var[None, :].astype(np.float32),
            np.ones((1, n), bool), np.log([[0.5, 0.5]]).astype(np.float32),
            np.array([[78.0, 97.0]], np.float32),
            np.array([[3.0, 3.0]], np.float32), device="cpu")
        w = np.exp(fit.log_weights.numpy()[0])
        mu, sd = fit.means.numpy()[0], fit.stdvs.numpy()[0]
        assert abs(w[0] - 0.6) < 0.05
        assert abs(mu[0] - 80.0) / 80.0 < 0.05
        assert abs(mu[1] - 95.0) / 95.0 < 0.05
        assert abs(sd[0] - 2.0) / 2.0 < 0.25
        assert abs(sd[1] - 3.0) / 3.0 < 0.25
    else:
        rng = np.random.default_rng(5)
        n = 400
        levels = np.stack([rng.normal(70.0, 1.5, n),
                           rng.normal(110.0, 2.5, n)]).astype(np.float32)
        logw = np.zeros((2, 2), np.float32)
        logw[:, 1] = -np.inf
        fit = em.train_gaussian_mixture_batched(
            levels, np.ones((2, n), np.float32), np.ones((2, n), bool), logw,
            np.array([[72.0, 1.0], [108.0, 1.0]], np.float32),
            np.array([[2.0, 1.0], [2.0, 1.0]], np.float32), device="cpu")
        mu = fit.means.numpy()
        assert abs(mu[0, 0] - 70.0) < 0.5
        assert abs(mu[1, 0] - 110.0) < 0.5


def test_invgauss_em_recovers_eta():
    """tests/test_mixture_em.py's inverse-Gaussian recovery on the port:
    event stdvs drawn from per-component inverse gaussians with per-event
    shape scaling; eta within 5%, lambda held, sd_stdv = sqrt(eta^3 /
    lambda), and the density against scipy's."""
    from scipy.stats import invgauss as scipy_ig
    rng = np.random.default_rng(23)
    n = 2000
    true_w, true_mu, true_sd = [0.55, 0.45], [82.0, 100.0], [2.0, 2.5]
    true_eta, lam = [1.3, 2.2], [24.0, 24.0]
    comp = rng.choice(2, size=n, p=true_w)
    ratio = rng.uniform(0.8, 1.25, size=n)
    level_means = rng.normal(np.take(true_mu, comp),
                             np.take(true_sd, comp)).astype(np.float32)
    lam_i = np.take(lam, comp) * ratio
    level_stdvs = scipy_ig.rvs(np.take(true_eta, comp) / lam_i, scale=lam_i,
                               random_state=rng).astype(np.float32)
    fit = em.train_invgaussian_mixture_batched(
        level_means[None, :], level_stdvs[None, :],
        np.ones((1, n), np.float32), ratio[None, :].astype(np.float32),
        np.ones((1, n), bool), np.log([true_w]).astype(np.float32),
        np.array([true_mu], np.float32), np.array([true_sd], np.float32),
        np.array([[1.0, 1.0]], np.float32), np.array([lam], np.float32),
        device="cpu")
    eta = fit.sd_means.numpy()[0]
    assert abs(eta[0] - 1.3) / 1.3 < 0.05
    assert abs(eta[1] - 2.2) / 2.2 < 0.05
    np.testing.assert_allclose(fit.sd_lambdas.numpy()[0], lam)
    np.testing.assert_allclose(fit.sd_stdvs.numpy()[0],
                               np.sqrt(eta ** 3 / np.array(lam)), rtol=1e-5)
    x = torch.linspace(0.2, 5.0, 50)
    ours = em.log_invgauss_pdf(x, torch.log(x), 1.5, 20.0,
                               float(np.log(20.0))).numpy()
    np.testing.assert_allclose(ours, scipy_ig.logpdf(x.numpy(), 1.5 / 20.0,
                                                     scale=20.0),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the mixture EM on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gaussian_em_on_card_matches_cpu(cuda_device):
    x = gaussian_inputs(0)
    want = em.train_gaussian_mixture_batched(*x, device="cpu")
    got = em.train_gaussian_mixture_batched(*x, device=cuda_device)
    assert _maxdiff(got.means, want.means.numpy()) <= MEAN_ATOL
    assert _maxdiff(got.stdvs, want.stdvs.numpy(), rel=True) <= STDV_RTOL
