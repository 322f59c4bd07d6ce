"""The samplers, optimizers and diagnostics of the port, under the JAX
package's names (bayes_drt_tpu.infer): SHMC (the bench's sampler) and
NUTS, the batched L-BFGS, the box QP and the hyper-lambda ridge. The arms
the JAX package fences (ChEES, ``fused_draws``, the flat-chain
trajectories) are reached through ``bayes_drt_tpu_torch.experiments``.
Importing this package builds no CUDA extension: the hand-written
kernels build at their first launch."""

from .chees import SHMCConfig, sample_shmc
from .diagnostics import (e_bfmi, ess, ess_bulk, ess_jnp, ess_tail, rhat,
                          rhat_rank, summary)
from .map import run_lbfgs, run_lbfgs_restarts
from .nnls import solve_nnls, solve_qp_box
from .nuts import NUTSConfig, sample_nuts
from .ridge import (HyperLambdaConfig, RidgeData, run_hyper_lambda,
                    run_hyper_weights, run_ordinary_ridge)

__all__ = ["SHMCConfig", "sample_shmc",
           "e_bfmi", "ess", "ess_bulk", "ess_jnp", "ess_tail", "rhat",
           "rhat_rank", "summary",
           "run_lbfgs", "run_lbfgs_restarts", "solve_nnls", "solve_qp_box",
           "NUTSConfig", "sample_nuts", "HyperLambdaConfig", "RidgeData",
           "run_hyper_lambda", "run_hyper_weights", "run_ordinary_ridge"]
