"""Stan-compatible log-density building blocks (port of
bayes_drt_tpu/models/priors.py:21-37). Constants are kept so log-posterior
values agree with the reference package."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _t(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def normal_lpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return torch.sum(-0.5 * z * z - torch.log(_t(sigma, x)) - _LOG_SQRT_2PI)


def std_normal_lpdf(x):
    return torch.sum(-0.5 * x * x - _LOG_SQRT_2PI)


def inv_gamma_lpdf(x, alpha, beta):
    """Stan inv_gamma(alpha, beta): alpha*log(beta) - lgamma(alpha)
    - (alpha+1)*log(x) - beta/x."""
    a, b = _t(alpha, x), _t(beta, x)
    return torch.sum(a * torch.log(b) - torch.lgamma(a)
                     - (a + 1.0) * torch.log(x) - b / x)
