"""The basis functions and matrix builders of the port, under the JAX
package's names (bayes_drt_tpu.ops). A DRT's A matrix comes from the
hand-written quadrature kernel (``quad.py``) on a CUDA device, built at
its first launch, not at import."""

from . import quad as pallas_quad  # the JAX package's name of the module
from .basis import gaussian_rbf, gaussian_rbf_dy, get_basis_func
from .matrices import (construct_A, construct_L, construct_M,
                       default_epsilon, get_tau_basis)

__all__ = [
    "get_basis_func",
    "gaussian_rbf",
    "gaussian_rbf_dy",
    "construct_A",
    "construct_L",
    "construct_M",
    "get_tau_basis",
    "default_epsilon",
]
