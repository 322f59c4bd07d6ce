"""The plots of viz/plotting.py and the Inverter's plot wrappers against
the JAX package's, on one MAP fit with its HN peaks (the JAX package's)
saved once and loaded into both packages' Inverters: every line's,
scatter's and band's plotted x/y data on the Agg backend, held to 1e-9
relative (the two packages' predictions from one state agree to ~1e-12
in float64)."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from bayes_drt_tpu import Inverter as JaxInverter  # noqa: E402
from bayes_drt_tpu import viz as jax_viz  # noqa: E402
from bayes_drt_tpu_torch import Inverter, sim, viz  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-9
FREQ = np.logspace(4, 0, 21)
Z = sim.add_simple_noise(sim.reference_circuit("ZARC", FREQ), 5, 0.0025)[0]


@pytest.fixture(scope="module")
def pair():
    src = JaxInverter()
    src.fit(FREQ, Z, init_from_ridge=True, max_iter=200, random_seed=0)
    src.fit_peaks()
    state = src.save_fit_data(which="all")
    a = JaxInverter()
    a.load_fit_data(dict(state))
    b = Inverter(device="cpu", dtype=torch.float64)
    b.load_fit_data(dict(state))
    return a, b


def plotted_data(fig):
    """Every artist's data on every axes of ``fig``, in drawing order."""
    out = []
    for ax in fig.axes:
        for ln in ax.lines:
            out.append(np.asarray(ln.get_xydata(), float))
        for col in ax.collections:
            off = np.asarray(col.get_offsets(), float)
            if off.size:
                out.append(off)
            for path in col.get_paths():
                out.append(np.asarray(path.vertices, float))
    return out


def _same(fig_a, fig_b, name):
    a, b = plotted_data(fig_a), plotted_data(fig_b)
    assert len(a) == len(b) > 0, name
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=RTOL,
                                   atol=RTOL * np.abs(x).max(),
                                   err_msg=name)
    plt.close(fig_a)
    plt.close(fig_b)


@pytest.mark.parametrize("name", ["plot_distribution", "plot_fit",
                                  "plot_residuals", "plot_full_results",
                                  "plot_peak_fit"])
def test_inverter_plot_wrappers_match_jax(pair, name):
    a, b = pair
    ra, rb = getattr(a, name)(), getattr(b, name)()
    fa = np.ravel(ra)[0].get_figure()
    fb = np.ravel(rb)[0].get_figure()
    _same(fa, fb, name)


def test_data_plots_match_jax(pair):
    a, b = pair
    df_a, df_b = a._train_df(), b._train_df()
    for name in ("plot_nyquist", "plot_bode", "plot_eis"):
        fa = np.ravel(getattr(jax_viz, name)(df_a))[0].get_figure()
        fb = np.ravel(getattr(viz, name)(df_b))[0].get_figure()
        _same(fa, fb, name)
    kw = dict(normalize=True, area=2.0, tau_plot=np.logspace(-6, 1, 50))
    fa = jax_viz.plot_distribution(df_a, a, **kw).get_figure()
    fb = viz.plot_distribution(df_b, b, **kw).get_figure()
    _same(fa, fb, "plot_distribution normalized")
    jv = pd.DataFrame({"Im": np.linspace(0.0, 1.0, 9),
                       "Vf": np.linspace(1.0, 0.6, 9)})
    fa = jax_viz.plot_jv(jv, area=1.5).get_figure()
    fb = viz.plot_jv(jv, area=1.5).get_figure()
    _same(fa, fb, "plot_jv")
