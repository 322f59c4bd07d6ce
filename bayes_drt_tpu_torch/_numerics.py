"""Device and precision policy of the port.

Reduced-precision gradients wreck leapfrog integration (plain bf16 gave
gamma RMSE 5.6 %Rp and logp split-Rhat 51 in the reference package's
precision A/B), so every float32 matrix product runs in true fp32: TF32 is
off for cuBLAS and cuDNN and the float32 matmul precision is "highest".
Importing this module applies the policy.
"""

from __future__ import annotations

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
