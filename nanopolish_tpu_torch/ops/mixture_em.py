"""Batched Gaussian mixture EM over all kmers at once.

Rebuild of train_gaussian_mixture (reference: src/training_core.cpp:13-135):
per-kmer 1-2 component mixtures with per-read variance scaling folded into
the components, 10 iterations.  The reference loops kmers under OpenMP;
here ALL kmers train together as one [R kmers, N events, C components]
program of tensor operations on ``device`` (``cuda`` unless the caller
asks for ``cpu``).

The arithmetic is f64, as the reference's doubles: the inputs are taken
as f32 and the results rounded to f32, so the card and the CPU, whose exp,
log and summation orders differ in the last bits of an f64, return the
same f32 values except where a result lies that close to an f32 rounding
boundary.

Masking follows the JAX package's program: masked events get zero
responsibility, and components whose log weight is -inf keep their
parameters.  Masked events' inputs are also replaced by 1.0 before any
arithmetic, so a NaN or inf in a padded lane never reaches a sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
LOG_2PI = math.log(2.0 * math.pi)


class MixtureFit(NamedTuple):
    log_weights: torch.Tensor   # [R, C]
    means: torch.Tensor         # [R, C]
    stdvs: torch.Tensor         # [R, C]


class InvGaussFit(NamedTuple):
    sd_means: torch.Tensor      # [R, C] eta (IG mean of event stdv)
    sd_lambdas: torch.Tensor    # [R, C] shape (held fixed, as the reference)
    sd_stdvs: torch.Tensor      # [R, C] sqrt(eta^3 / lambda)


def _f64(x, dev) -> torch.Tensor:
    """An f32 input (rounded to f32 first, as the f32 program takes it),
    widened to f64 on ``dev``."""
    if torch.is_tensor(x):
        x = x.to(device=dev, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return x.to(torch.float64)


def _mask(mask, dev) -> torch.Tensor:
    """[R, N] event validity -> [R, N, 1] bool on ``dev``."""
    return torch.as_tensor(mask, device=dev).to(torch.bool)[:, :, None]


def _events(x, m, dev) -> torch.Tensor:
    """[R, N] per-event input -> [R, N, 1] f64, 1.0 where masked."""
    return torch.where(m, _f64(x, dev)[:, :, None], 1.0)


def train_gaussian_mixture_batched(levels, scaled_read_var, mask,
                                   log_weights0, means0, stdvs0,
                                   n_iter: int = 10,
                                   device=None) -> MixtureFit:
    """EM over [R] kmers x [N] events x [C] components on ``device``.

    Args:
      levels:          [R, N] f32 fully-scaled event levels
      scaled_read_var: [R, N] f32 read var / read scale
      mask:            [R, N] bool event validity
      log_weights0:    [R, C] f32 (-inf disables a component)
      means0, stdvs0:  [R, C] f32 initial component parameters
    """
    dev = resolve_device(device)
    m = _mask(mask, dev)
    x = _events(levels, m, dev)                               # [R, N, 1]
    svar = _events(scaled_read_var, m, dev)
    log_w = _f64(log_weights0, dev)                           # [R, C]
    mu = _f64(means0, dev)
    sd = _f64(stdvs0, dev)
    # disabled components (log_w == -inf) keep their params
    enabled = torch.isfinite(log_w)
    for _ in range(n_iter):
        comp_sd = sd[:, None, :] * svar                       # [R, N, C]
        z = (x - mu[:, None, :]) / comp_sd
        log_pdf = -0.5 * z * z - torch.log(comp_sd) - LOG_SQRT_2PI
        log_num = log_w[:, None, :] + log_pdf
        log_den = torch.logsumexp(log_num, dim=2, keepdim=True)
        resp = torch.where(m, torch.exp(log_num - log_den), 0.0)

        n_j = resp.sum(dim=1)                                 # [R, C]
        n_tot = n_j.sum(dim=1, keepdim=True)
        n_j_c = torch.clamp(n_j, min=1e-30)
        new_log_w = torch.log(n_j_c) - torch.log(torch.clamp(n_tot,
                                                             min=1e-30))
        new_mu = (resp * x).sum(dim=1) / n_j_c
        dev_ = (x - new_mu[:, None, :]) / svar
        new_var = (resp * dev_ * dev_).sum(dim=1) / n_j_c
        new_sd = torch.sqrt(torch.clamp(new_var, min=1e-12))
        log_w = torch.where(enabled, new_log_w, log_w)
        mu = torch.where(enabled, new_mu, mu)
        sd = torch.where(enabled, new_sd, sd)
    return MixtureFit(log_weights=log_w.float(), means=mu.float(),
                      stdvs=sd.float())


def log_invgauss_pdf(x, log_x, eta, lam, log_lam):
    """log inverse-Gaussian density f(x; eta, lambda) =
    sqrt(lambda / (2 pi x^3)) * exp(-lambda (x - eta)^2 / (2 eta^2 x))."""
    d = x - eta
    return 0.5 * (log_lam - LOG_2PI - 3.0 * log_x) \
        - lam * d * d / (2.0 * eta * eta * x)


def train_invgaussian_mixture_batched(level_means, level_stdvs,
                                      scaled_read_var, var_sd_ratio, mask,
                                      log_weights0, means0, stdvs0,
                                      sd_means0, sd_lambdas0,
                                      n_iter: int = 10,
                                      device=None) -> InvGaussFit:
    """Inverse-Gaussian mixture update of the per-kmer event-noise model,
    batched over [R] kmers x [N] events x [C] components on ``device``.

    Rebuild of train_invgaussian_mixture (reference:
    src/training_core.cpp:143-270, the algorithm of its disabled body):
      1. gaussian responsibilities g[i,j] over level_mean, computed once
         from the input mixture;
      2. per iteration: IG pdfs over level_stdv with per-event shape
         lambda'_ij = lambda_j * var_sd_ratio_i, responsibilities
         proportional to g[i,j] * IG(x_i; eta_j, lambda'_ij), and the
         update eta_j := sum_i(ig*lambda'*x) / sum_i(ig*lambda');
      3. lambda_j is held fixed and sd_stdv = sqrt(eta^3/lambda).

    Args:
      level_means:  [R, N] f32 fully-scaled event levels
      level_stdvs:  [R, N] f32 scaled event stdvs (IG observations)
      scaled_read_var: [R, N] f32 read var/scale (gaussian widths)
      var_sd_ratio: [R, N] f32 read var_sd / scale_sd per event
      mask:         [R, N] bool event validity
      log_weights0, means0, stdvs0: [R, C] input gaussian mixture
      sd_means0, sd_lambdas0: [R, C] input IG noise parameters
    """
    dev = resolve_device(device)
    m = _mask(mask, dev)
    x_mu = _events(level_means, m, dev)
    x_sd = _events(level_stdvs, m, dev)
    log_x_sd = torch.log(torch.clamp(x_sd, min=1e-12))
    svar = _events(scaled_read_var, m, dev)
    ratio = _events(var_sd_ratio, m, dev)

    # gaussian responsibilities (computed once, training_core.cpp:169-196)
    mu0 = _f64(means0, dev)[:, None, :]
    comp_sd = _f64(stdvs0, dev)[:, None, :] * svar
    z = (x_mu - mu0) / comp_sd
    log_g = _f64(log_weights0, dev)[:, None, :] \
        - 0.5 * z * z - torch.log(comp_sd) - LOG_SQRT_2PI
    log_g = log_g - torch.logsumexp(log_g, dim=2, keepdim=True)
    log_g = torch.where(m, log_g, float("-inf"))

    lam0 = _f64(sd_lambdas0, dev)
    log_lam_ij = torch.log(lam0)[:, None, :] + torch.log(ratio)  # [R, N, C]
    lam_ij = lam0[:, None, :] * ratio

    eta = _f64(sd_means0, dev)
    for _ in range(n_iter):
        log_pdf = log_invgauss_pdf(x_sd, log_x_sd, eta[:, None, :],
                                   lam_ij, log_lam_ij)
        log_num = log_g + torch.where(m, log_pdf, 0.0)
        log_den = torch.logsumexp(log_num, dim=2, keepdim=True)
        ig = torch.where(m, torch.exp(log_num - log_den), 0.0)
        wl = ig * lam_ij
        num = (wl * x_sd).sum(dim=1)
        den = wl.sum(dim=1)
        new_eta = num / torch.clamp(den, min=1e-30)
        eta = torch.where(den > 1e-30, new_eta, eta)
    sd_stdv = torch.sqrt(eta * eta * eta / lam0)
    return InvGaussFit(sd_means=eta.float(), sd_lambdas=lam0.float(),
                       sd_stdvs=sd_stdv.float())
