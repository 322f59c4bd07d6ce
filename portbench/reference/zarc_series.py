"""Plain reference of the zarc_series configuration: the Stan Series
model (one series DRT, non-centered) on the configuration's grid, by
``plainmodel.Model``; its analytic truth is the ZARC's DRT (``gen``)."""

from portbench.gen import truths
from portbench.plainmodel import from_config as model

__all__ = ["model", "truths"]
