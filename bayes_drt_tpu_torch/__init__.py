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
with nvcc at first use. Entry points run on CUDA unless called with
``device="cpu"``. This package imports neither JAX nor the JAX package.
"""

from . import _numerics  # noqa: F401  (applies the fp32 matmul policy)
from . import ecm, peaks, sbc, sim
from .inverter import Inverter
from .parallel import (drift_fit_spectra_batch, fit_spectra_batch,
                       fit_spectra_ragged)

__all__ = ["Inverter", "drift_fit_spectra_batch", "ecm", "fit_spectra_batch",
           "fit_spectra_ragged", "peaks", "sbc", "sim"]
