"""DRT A-matrix quadrature: the hand-written CUDA kernel (csrc/quad.cu),
its plain PyTorch version and ``construct_A_drt_quad`` (port of
bayes_drt_tpu/ops/pallas_quad.py).

``drt_quad`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import _build
from .kernels import drt_imag_kernel, drt_real_kernel


def drt_quad_plain(s, y, phiw, part: str):
    """A[n, k] = sum_q phiw[q] K(y[q] + s[n, k]) as one (N, K, Q) einsum."""
    if part == "real":
        f = drt_real_kernel(y[None, None, :], s[:, :, None])
    elif part == "imag":
        f = drt_imag_kernel(y[None, None, :], s[:, :, None])
    else:
        raise ValueError(f"Invalid part {part!r}")
    return torch.einsum("nkq,q->nk", f, phiw)


def _launch_kernel(s, y, phiw, part):
    if part not in ("real", "imag"):
        raise ValueError(f"Invalid part {part!r}")
    dt = s.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"drt_quad takes float32 or float64, got {dt}")
    for name, t in (("y", y), ("phiw", phiw)):
        if t.device != s.device or t.dtype != dt:
            raise ValueError(f"{name} must match s in device and dtype")
    if s.ndim != 2 or y.ndim != 1 or phiw.shape != y.shape:
        raise ValueError("drt_quad takes s (N, K), y (Q,), phiw (Q,)")
    s, y, phiw = s.contiguous(), y.contiguous(), phiw.contiguous()
    out = torch.empty_like(s)
    lib = _build.load("quad")
    fn = lib.drt_quad_f32 if dt == torch.float32 else lib.drt_quad_f64
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s.data_ptr(), y.data_ptr(), phiw.data_ptr(), s.numel(),
                    y.numel(), int(part == "imag"), out.data_ptr(), stream)
    _build.check(status, "drt_quad")
    drt_quad.launches += 1
    return out


def drt_quad(s, y, phiw, part: str):
    """DRT quadrature sum over nodes ``y`` with weights ``phiw`` (basis
    times trapezoid weight) at log-offsets ``s`` (N, K). CPU tensors take
    the plain version; CUDA tensors launch csrc/quad.cu (or raise)."""
    if s.device.type == "cpu":
        return drt_quad_plain(s, y, phiw, part)
    if s.device.type != "cuda":
        raise ValueError(f"drt_quad runs on cpu or cuda, not {s.device}")
    return _launch_kernel(s, y, phiw, part)


drt_quad.launches = 0


def construct_A_drt_quad(frequencies, part, tau=None, epsilon=1.0,
                         n_quad: int = 1024, y_max: float = 20.0,
                         dtype=torch.float32, device=None):
    """DRT A matrix through ``drt_quad`` (counterpart of
    construct_A_drt_pallas): Gaussian basis, trapezoid rule with
    ``n_quad`` points on [-y_max, y_max], float32 by default."""
    from .matrices import construct_A  # matrices imports this module
    return construct_A(frequencies, part, tau=tau, epsilon=epsilon,
                       n_quad=n_quad, y_max=y_max, dtype=dtype,
                       device=device)
