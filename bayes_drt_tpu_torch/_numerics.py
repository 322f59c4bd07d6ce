"""Device and precision policy of the port.

Reduced-precision gradients wreck leapfrog integration (plain bf16 gave
gamma RMSE 5.6 %Rp and logp split-Rhat 51 in the reference package's
precision A/B), so every float32 matrix product runs in true fp32: TF32 is
off for cuBLAS and cuDNN and the float32 matmul precision is "highest".
Importing this module applies the policy. ``tf32x3_matmul`` is the
opt-in reduced-precision product (SHMCConfig(precision='high')), the
counterpart of the JAX package's bf16x3, with TF32 enabled only inside
the call; ``matmul`` routes a posterior product through it where the
thread's precision context (progcache.precise_matmuls) asks for it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent CPU fallback: asking for CUDA (explicitly
    or by default) without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """numpy/torch/str dtype -> torch float dtype (default float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported dtype {dtype!r}; use float32 or float64")
    return getattr(torch, name)


_CAPTURE_LOCK = threading.Lock()
_DEVICE_LOCKS: dict = {}


@contextmanager
def graph_capture(graph, device, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` on ``device``, its capture
    confined to this thread (``capture_error_mode='thread_local'``: a
    mesh's other shards, each in a host thread of its own on its own
    device, keep running while one captures) and serialized per device,
    so that no capture overlaps another thread's capture there."""
    with _CAPTURE_LOCK:
        lock = _DEVICE_LOCKS.setdefault(str(device), threading.Lock())
    with lock, torch.cuda.graph(graph, pool=pool,
                                capture_error_mode="thread_local"):
        yield


def tf32_round(x):
    """Float32 ``x`` rounded to TF32 (10 explicit mantissa bits) to
    nearest, ties to even; infinities and NaNs pass through."""
    i = x.contiguous().view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


_TF32_LOCK = threading.Lock()


def _tf32x3(a, b):
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = a - a_hi, b - b_hi
    if a.is_cuda:
        # TF32 is a process-wide cuBLAS setting: on only for these three
        # launches, under a lock so that no other thread's product of
        # this process switches it back in between
        with _TF32_LOCK:
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
    # no TF32 unit: the tensor cores' products of the TF32 pieces (each
    # product of two 11-bit significands exact in fp32), up to the order
    # of their sums
    return a_hi @ b_hi + (a_hi @ tf32_round(b_lo) + tf32_round(a_lo) @ b_hi)


class _TF32x3Matmul(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return _tf32x3(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _tf32x3(g, b.mT).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = _tf32x3(a.mT, g).sum_to_size(b.shape)
        return ga, gb


def tf32x3_matmul(a, b):
    """a @ b (float32, at least 2-d each) as three TF32 products: a =
    a_hi + a_lo with a_hi rounded to TF32, b likewise, and a_hi @ b_hi +
    a_hi @ b_lo + a_lo @ b_hi, the lo @ lo term dropped (a relative error
    of order 2^-21 against the fp32 product's 2^-24). On a CUDA device
    the products run on the TF32 tensor cores; on the CPU the same
    pieces multiply in fp32, which emulates them. The backward pass
    multiplies the same way (as the JAX package's matmul precision holds
    for the gradient too)."""
    return _TF32x3Matmul.apply(a, b)


def matmul(a, b):
    """a @ b at the thread's posterior matmul precision: tf32x3 for a
    float32 product on a CUDA device under 'high', true fp32 (or the
    dtype's own product) in every other case, the CPU's included."""
    if a.is_cuda and a.dtype == torch.float32 and b.dtype == torch.float32:
        from .progcache import matmul_precision
        if matmul_precision() == "high":
            return tf32x3_matmul(a, b)
    return a @ b
