from .plotting import (match_axis_scales, plot_bode, plot_distribution,
                       plot_eis, plot_fit, plot_full_results, plot_jv,
                       plot_nyquist, plot_ocv, plot_residuals)

__all__ = ["match_axis_scales", "plot_bode", "plot_distribution", "plot_eis", "plot_fit",
           "plot_full_results", "plot_jv", "plot_nyquist", "plot_ocv",
           "plot_residuals"]
