"""Stan-compatible log-density building blocks (port of
bayes_drt_tpu/models/priors.py). Constants are kept so log-posterior
values agree with the reference package.

Each lpdf sums over the last dimension of ``x`` and broadcasts over the
leading ones (pass a scalar parameter as ``x[..., None]``). Hyperparameters
are Python floats or 0-d tensors; no tensor is made from a Python number
here, so the functions can run inside a CUDA-graph capture.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def normal_lpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return torch.sum(-0.5 * z * z - _log(sigma) - _LOG_SQRT_2PI, dim=-1)


def std_normal_lpdf(x):
    return torch.sum(-0.5 * x * x - _LOG_SQRT_2PI, dim=-1)


def inv_gamma_lpdf(x, alpha, beta):
    """Stan inv_gamma(alpha, beta): alpha*log(beta) - lgamma(alpha)
    - (alpha+1)*log(x) - beta/x."""
    return torch.sum(alpha * _log(beta) - _lgamma(alpha)
                     - (alpha + 1.0) * torch.log(x) - beta / x, dim=-1)


def exponential_lpdf(x, lam):
    return torch.sum(_log(lam) - lam * x, dim=-1)
