"""Plain reference of the sp_drt_ddt configuration: the Stan
Series-Parallel_pos model (a series DRT and a transmissive planar
parallel DDT, nonneg, non-centered) on the configuration's grid, by
``plainmodel.Model``; its analytic truths are the ZARC's DRT and the
Cole-Cole distribution of diffusion times (``gen``)."""

from portbench.gen import truths
from portbench.plainmodel import from_config as model

__all__ = ["model", "truths"]
