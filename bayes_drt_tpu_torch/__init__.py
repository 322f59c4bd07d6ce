"""PyTorch/CUDA port of bayes_drt_tpu: batched Bayesian DRT inversion of
EIS spectra on an NVIDIA H100.

The main path is ``parallel.fit_spectra_batch`` (flat-chain SHMC on the
single series-DRT posterior); ``parallel.fit_spectra_ragged`` fits spectra
measured on different grids; ``parallel.drift_fit_spectra_batch`` fits
fleets of time-evolving spectra; ``Inverter`` is the single-spectrum
surface (ridge, MAP, sampled and drift fits, HN peak fits, predictions,
save/load); ``peaks`` and ``ecm`` fit Havriliak-Negami peaks and
equivalent circuits with a bounded Levenberg-Marquardt solver; ``sbc``
runs simulation-based calibration of the sampler; ``python -m
bayes_drt_tpu_torch fit`` (``cli``) fits a directory of instrument files,
read by the C++ loader of ``native`` (``io`` and ``viz`` hold the pandas
readers and the matplotlib plots, imported when called). The two hot
kernels are hand-written CUDA (``csrc/traj.cu``, ``csrc/quad.cu``), built
with nvcc at first use. The matrix builders (``construct_A``,
``construct_L``, ``construct_M``, ``get_tau_basis``, ``get_basis_func``)
are exported as the JAX package exports them. Entry points run on CUDA
unless called with ``device="cpu"``. This package imports neither JAX nor
the JAX package.
"""

from . import _numerics  # noqa: F401  (applies the fp32 matmul policy)
from . import ecm, peaks, sbc, sim
from .inverter import Inverter
from .ops.basis import get_basis_func
from .ops.matrices import construct_A, construct_L, construct_M, get_tau_basis
from .parallel import (drift_fit_spectra_batch, fit_spectra_batch,
                       fit_spectra_ragged)

__version__ = "0.1.0"

__all__ = ["Inverter", "__version__", "construct_A", "construct_L",
           "construct_M", "drift_fit_spectra_batch", "ecm",
           "fit_spectra_batch", "fit_spectra_ragged", "get_basis_func",
           "get_tau_basis", "peaks", "sbc", "sim"]
