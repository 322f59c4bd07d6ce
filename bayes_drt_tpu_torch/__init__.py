"""PyTorch/CUDA port of bayes_drt_tpu: batched Bayesian DRT inversion of
EIS spectra on an NVIDIA H100.

The main path is ``parallel.fit_spectra_batch`` (flat-chain SHMC on the
single series-DRT posterior); ``parallel.fit_spectra_ragged`` fits spectra
measured on different grids; ``Inverter`` is the single-spectrum surface
(ridge, MAP and sampled fits, predictions, save/load). The two hot kernels are hand-written CUDA
(``csrc/traj.cu``, ``csrc/quad.cu``), built with nvcc at first use.
Entry points run on CUDA unless called with ``device="cpu"``. This package
imports neither JAX nor the JAX package.
"""

from . import _numerics  # noqa: F401  (applies the fp32 matmul policy)
from .inverter import Inverter
from .parallel import fit_spectra_batch, fit_spectra_ragged

__all__ = ["Inverter", "fit_spectra_batch", "fit_spectra_ragged"]
