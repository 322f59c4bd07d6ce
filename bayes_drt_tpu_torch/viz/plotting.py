"""Plotting: Nyquist/Bode/EIS data plots, distribution plots with credible
bands, fit overlays and residual diagnostics (copy of
bayes_drt_tpu/viz/plotting.py, which this package may not import;
reference: bayes_drt/plotting.py). Matplotlib, host-side only, imported
inside the functions, so the package imports without it. The fit plots
call the port Inverter's predictors.
"""

from __future__ import annotations

import numpy as np

from ..utils import get_factor_from_unit, get_unit_scale


def _scaled(df, area):
    f = df["Freq"].values
    z = df["Zreal"].values + 1j * df["Zimag"].values
    if area is not None:
        z = z * area
    return f, z


def _expand_lim(lo, hi, data, zero_floor):
    """Expand an axis interval to cover ``data`` with a 10% margin.

    Expand-only (overlay calls accumulate limits across datasets), and when
    the data is non-negative the lower limit is floored at 0 — the two rules
    of the reference's Nyquist limit handling (reference: plotting.py:186-216)."""
    rng = data.max() - data.min()
    if data.min() < lo:
        lo = data.min() - 0.1 * rng
    if data.max() > hi:
        hi = data.max() + 0.1 * rng
    if zero_floor and data.min() >= 0:
        # also clamps matplotlib's auto-margin, which dips slightly below 0
        # (tightening of the reference's "don't go negative" intent)
        lo = max(0.0, lo)
    return lo, hi


def match_axis_scales(ax, y_data=None):
    """Make one data unit span the same number of inches on x and y.

    The reference's visual-scale matcher (reference: plotting.py:218-253):
    measure the axes box in figure inches, compare units-per-inch on each
    axis, and EXPAND the tighter-scaled axis to match — never shrink, so
    repeated overlay calls only ever grow the view. Expansion respects the
    zero floor: a non-negative axis grows rightward/upward once its lower
    limit hits 0; a sign-spanning y axis distributes growth proportionally
    between the negative and positive sides. ``y_data`` (optional) tells the
    sign check about the plotted -Z'' values; otherwise the current lower
    limit decides."""
    fig = ax.get_figure()
    xlo, xhi = ax.get_xlim()
    ylo, yhi = ax.get_ylim()
    bbox = ax.get_window_extent().transformed(fig.dpi_scale_trans.inverted())
    xscale = (xhi - xlo) / bbox.width
    yscale = (yhi - ylo) / bbox.height
    if yscale > xscale:
        extra = (yscale - xscale) * bbox.width
        new_lo = max(0.0, xlo - extra / 2) if xlo >= 0 else xlo - extra / 2
        ax.set_xlim(new_lo, xhi + extra - (xlo - new_lo))
    elif xscale > yscale:
        extra = (xscale - yscale) * bbox.height
        y_min = ylo if y_data is None else np.min(y_data)
        if y_min >= 0:
            new_lo = max(0.0, ylo - extra / 2)
            ax.set_ylim(new_lo, yhi + extra - (ylo - new_lo))
        else:
            neg, pos = abs(ylo), abs(yhi)
            ax.set_ylim(ylo - extra * neg / (neg + pos),
                        yhi + extra * pos / (neg + pos))
    return ax


def plot_nyquist(df, area=None, ax=None, label="", plot_func="scatter",
                 unit_scale="auto", set_aspect_ratio=True, **plt_kw):
    """-Z'' vs Z' with equal axis scaling (reference: plotting.py:112-254)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(4.5, 3.5))
    f, z = _scaled(df, area)
    if unit_scale == "auto":
        unit_scale = get_unit_scale(df, area)
    factor = get_factor_from_unit(unit_scale) if unit_scale else 1.0
    x = z.real / factor
    y = -z.imag / factor
    if plot_func == "scatter":
        ax.scatter(x, y, s=plt_kw.pop("s", 10), label=label, **plt_kw)
    else:
        ax.plot(x, y, label=label, **plt_kw)
    area_str = "$\\cdot \\mathrm{cm}^2$" if area is not None else ""
    ax.set_xlabel(f"$Z^{{\\prime}}$ / {unit_scale}$\\Omega${area_str}")
    ax.set_ylabel(f"$-Z^{{\\prime\\prime}}$ / {unit_scale}$\\Omega${area_str}")
    if label:
        ax.legend()
    if set_aspect_ratio:
        ax.set_ylim(*_expand_lim(*ax.get_ylim(), y, zero_floor=True))
        ax.set_xlim(*_expand_lim(*ax.get_xlim(), x, zero_floor=True))
        match_axis_scales(ax, y_data=y)
    return ax


def plot_bode(df, area=None, axes=None, label="", plot_func="scatter",
              cols=None, unit_scale="auto", invert_phase=True, **plt_kw):
    """Bode panels (reference: plotting.py:257-385). cols selects plotted
    quantities from Zreal/Zimag/Zmod/Zphz."""
    import matplotlib.pyplot as plt

    if cols is None:
        cols = ["Zmod", "Zphz"]
    if axes is None:
        _, axes = plt.subplots(1, len(cols), figsize=(4 * len(cols), 3))
    axes = np.atleast_1d(axes)
    f, z = _scaled(df, area)
    if unit_scale == "auto":
        unit_scale = get_unit_scale(df, area)
    factor = get_factor_from_unit(unit_scale) if unit_scale else 1.0
    series = {
        "Zreal": (z.real / factor, f"$Z^{{\\prime}}$ / {unit_scale}$\\Omega$"),
        "Zimag": (-z.imag / factor,
                  f"$-Z^{{\\prime\\prime}}$ / {unit_scale}$\\Omega$"),
        "Zmod": (np.abs(z) / factor, f"$|Z|$ / {unit_scale}$\\Omega$"),
        "Zphz": (-np.degrees(np.arctan2(z.imag, z.real)) if invert_phase
                 else np.degrees(np.arctan2(z.imag, z.real)),
                 r"$-\varphi$ / $^\circ$" if invert_phase
                 else r"$\varphi$ / $^\circ$"),
    }
    marker_size = plt_kw.pop("s", 10)
    for ax, col in zip(axes, cols):
        y, ylabel = series[col]
        if plot_func == "scatter":
            ax.scatter(f, y, s=marker_size, label=label, **plt_kw)
        else:
            ax.plot(f, y, label=label, **plt_kw)
        ax.set_xscale("log")
        if col == "Zmod":
            ax.set_yscale("log")
        ax.set_xlabel("$f$ / Hz")
        ax.set_ylabel(ylabel)
        if label:
            ax.legend()
    return axes


def plot_eis(df, plot_type="all", area=None, axes=None, label="",
             plot_func="scatter", unit_scale="auto", bode_cols=None, **plt_kw):
    """Combined Nyquist + Bode (reference: plotting.py:388-455)."""
    import matplotlib.pyplot as plt

    if plot_type == "nyquist":
        return plot_nyquist(df, area=area, ax=axes, label=label,
                            plot_func=plot_func, unit_scale=unit_scale, **plt_kw)
    if plot_type == "bode":
        return plot_bode(df, area=area, axes=axes, label=label,
                         plot_func=plot_func, cols=bode_cols,
                         unit_scale=unit_scale, **plt_kw)
    if axes is None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    plot_nyquist(df, area=area, ax=axes[0], label=label, plot_func=plot_func,
                 unit_scale=unit_scale, **plt_kw)
    plot_bode(df, area=area, axes=axes[1:], label=label, plot_func=plot_func,
              cols=bode_cols, unit_scale=unit_scale, **plt_kw)
    plt.tight_layout()
    return axes


def plot_distribution(df, inv, ax=None, distribution=None, tau_plot=None,
                      plot_bounds=True, plot_ci=True, label="", ci_label="",
                      unit_scale="auto", freq_axis=True, area=None,
                      normalize=False, predict_kw=None, **plt_kw):
    """Recovered gamma(tau) with optional 95% credible band
    (reference: plotting.py:458-595)."""
    import matplotlib.pyplot as plt

    if predict_kw is None:
        predict_kw = {}
    if ax is None:
        _, ax = plt.subplots(figsize=(4.5, 3.2))
    if distribution is None:
        distribution = list(inv.distributions.keys())[0]
    if tau_plot is None:
        basis_tau = inv.distributions[distribution]["tau"]
        tmin, tmax = np.log10(basis_tau.min()), np.log10(basis_tau.max())
        tau_plot = np.logspace(tmin, tmax, 200)

    gamma = inv.predict_distribution(distribution, eval_tau=tau_plot,
                                     **predict_kw)
    scale = 1.0
    if normalize:
        scale = 1.0 / inv.predict_Rp(distributions=distribution)
    if area is not None:
        gamma = gamma * area
    if unit_scale == "auto" and df is not None:
        unit_scale = get_unit_scale(df, area)
    elif unit_scale == "auto":
        unit_scale = ""
    factor = get_factor_from_unit(unit_scale) if unit_scale else 1.0

    ax.plot(tau_plot, gamma * scale / factor, label=label, **plt_kw)
    if plot_ci and inv.fit_type == "bayes":
        lo = inv.predict_distribution(distribution, eval_tau=tau_plot,
                                      percentile=2.5, **predict_kw)
        hi = inv.predict_distribution(distribution, eval_tau=tau_plot,
                                      percentile=97.5, **predict_kw)
        if area is not None:
            lo, hi = lo * area, hi * area
        ax.fill_between(tau_plot, lo * scale / factor, hi * scale / factor,
                        alpha=0.25, label=ci_label or None)
    if plot_bounds and df is not None:
        f = df["Freq"].values
        for fb in (f.max(), f.min()):
            ax.axvline(1.0 / (2 * np.pi * fb), ls=":", c="gray", lw=1)
    ax.set_xscale("log")
    ax.set_xlabel(r"$\tau$ / s")
    if normalize:
        ax.set_ylabel(r"$\gamma \, / \, R_p$")
    else:
        ax.set_ylabel(f"$\\gamma$ / {unit_scale}$\\Omega$")
    if freq_axis:
        ax2 = ax.secondary_xaxis(
            "top", functions=(lambda t: 1.0 / (2 * np.pi * np.maximum(t, 1e-300)),
                              lambda f: 1.0 / (2 * np.pi * np.maximum(f, 1e-300))))
        ax2.set_xlabel("$f$ / Hz")
    if label or ci_label:
        ax.legend()
    return ax


def plot_fit(df, inv, axes=None, plot_type="all", bode_cols=None,
             plot_data=True, color="k", f_pred=None, label="fit",
             data_label="data", predict_kw=None, **plt_kw):
    """Measured data with model fit overlay (reference: plotting.py:598-684)."""
    import matplotlib.pyplot as plt

    from ..io.file_load import construct_eis_df
    if predict_kw is None:
        predict_kw = {}
    if bode_cols is None:
        bode_cols = ["Zreal", "Zimag"]
    f = df["Freq"].values
    if f_pred is None:
        f_pred = np.logspace(np.log10(f.min()), np.log10(f.max()), 200)[::-1]
    z_pred = inv.predict_Z(f_pred, **predict_kw)
    fit_df = construct_eis_df(f_pred, z_pred)

    if plot_type == "nyquist":
        ax = axes
        if plot_data:
            ax = plot_nyquist(df, ax=ax, label=data_label)
        return plot_nyquist(fit_df, ax=ax, plot_func="plot", color=color,
                            label=label, **plt_kw)
    if plot_type == "bode":
        if plot_data:
            axes = plot_bode(df, axes=axes, label=data_label, cols=bode_cols)
        return plot_bode(fit_df, axes=axes, plot_func="plot", color=color,
                         cols=bode_cols, label=label, **plt_kw)
    if axes is None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    if plot_data:
        plot_nyquist(df, ax=axes[0], label=data_label)
        plot_bode(df, axes=axes[1:], label=data_label, cols=bode_cols)
    plot_nyquist(fit_df, ax=axes[0], plot_func="plot", color=color,
                 label=label, **plt_kw)
    plot_bode(fit_df, axes=axes[1:], plot_func="plot", color=color,
              cols=bode_cols, label=label, **plt_kw)
    plt.tight_layout()
    return axes


def plot_residuals(df, inv, axes=None, unit_scale="auto", plot_ci=True,
                   predict_kw=None):
    """Real/imag residuals with +-3 sigma band from the fitted error model
    (reference: plotting.py:687-740)."""
    import matplotlib.pyplot as plt

    if predict_kw is None:
        predict_kw = {}
    if axes is None:
        _, axes = plt.subplots(1, 2, figsize=(8, 3))
    f = df["Freq"].values
    z = df["Zreal"].values + 1j * df["Zimag"].values
    z_pred = inv.predict_Z(f, **predict_kw)
    if unit_scale == "auto":
        unit_scale = get_unit_scale(df)
    factor = get_factor_from_unit(unit_scale) if unit_scale else 1.0
    resid = (z_pred - z) / factor
    axes[0].scatter(f, resid.real, s=10)
    axes[1].scatter(f, resid.imag, s=10)
    if plot_ci and inv.fit_type in ("map", "bayes"):
        s_re, s_im = inv.predict_sigma(f)
        axes[0].fill_between(f, -3 * s_re / factor, 3 * s_re / factor,
                             color="gray", alpha=0.25, label=r"$\pm 3\sigma$")
        axes[1].fill_between(f, -3 * s_im / factor, 3 * s_im / factor,
                             color="gray", alpha=0.25, label=r"$\pm 3\sigma$")
    for ax, part in zip(axes, ("\\prime", "\\prime\\prime")):
        ax.axhline(0, c="k", lw=0.5)
        ax.set_xscale("log")
        ax.set_xlabel("$f$ / Hz")
        ax.set_ylabel(f"$\\hat{{Z}}^{{{part}}} - Z^{{{part}}}$ / "
                      f"{unit_scale}$\\Omega$")
        ax.legend()
    plt.tight_layout()
    return axes


def plot_full_results(df, inv, axes=None, bode_cols=None, plot_data=True,
                      color="k", predict_kw=None, **plt_kw):
    """2x3 grid: fit (nyquist + bode) on top, DRT + residuals below
    (reference: plotting.py:743-817)."""
    import matplotlib.pyplot as plt

    if bode_cols is None:
        bode_cols = ["Zreal", "Zimag"]
    if axes is None:
        fig, axes = plt.subplots(2, 3, figsize=(12, 6.5))
    plot_fit(df, inv, axes=axes[0], bode_cols=bode_cols, plot_data=plot_data,
             color=color, predict_kw=predict_kw or {}, **plt_kw)
    plot_distribution(df, inv, ax=axes[1, 0], predict_kw=predict_kw or {})
    plot_residuals(df, inv, axes=axes[1, 1:], predict_kw=predict_kw or {})
    plt.tight_layout()
    return axes


def plot_ocv(data, filter_func=None, files=None, ax=None, invert="auto",
             same_color=True, **plt_kw):
    """OCV vs time (reference: plotting.py:14-57).

    ``data`` may be a DataFrame from ``read_ocv`` (single trace), or a
    directory path: every matching OCV/OCP .DTA file is loaded and overlaid
    on a common time axis anchored at the earliest file's start timestamp.
    Select files with ``files`` (name or list of names) or ``filter_func``
    (filename predicate); default grabs OCV*/OCP* .DTA. ``invert='auto'``
    flips the sign so the dominant voltage plots positive."""
    import matplotlib.pyplot as plt

    import os

    import pandas as pd

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3))

    if hasattr(data, "columns"):  # single DataFrame trace
        t_col = "T" if "T" in data.columns else "Time"
        ax.plot(data[t_col].values / 3600.0, data["Vf"].values, **plt_kw)
        ax.set_xlabel("$t$ / h")
        ax.set_ylabel("OCV / V")
        return ax

    from ..io.file_load import read_ocv

    datadir = os.fspath(data)
    if filter_func is not None and files is not None:
        raise ValueError("Both filter_func and files have been specified. "
                         "Please specify only one")
    if files is None:
        if filter_func is None:
            filter_func = (lambda f: f[:3] in ("OCV", "OCP")
                           and f[-3:] == "DTA")
        files = sorted(f for f in os.listdir(datadir) if filter_func(f))
    elif isinstance(files, str):
        files = [files]

    dfs = [read_ocv(os.path.join(datadir, f)) for f in files]
    dfs = [df for df in dfs if len(df) > 0]
    if not dfs:
        raise ValueError(f"No non-empty OCV files found in {datadir}")
    t0 = min(df["timestamp"].iloc[0] for df in dfs)

    if invert == "auto":
        allv = pd.concat([df["Vf"] for df in dfs], ignore_index=True)
        v_sign = np.sign(allv.iloc[allv.abs().idxmax()])
    else:
        v_sign = -1.0 if invert else 1.0

    if same_color and not ({"c", "color"} & set(plt_kw)):
        plt_kw["c"] = plt.rcParams["axes.prop_cycle"].by_key()["color"][0]
    for df in dfs:
        t_h = (df["timestamp"] - t0).dt.total_seconds() / 3600.0
        ax.plot(t_h, v_sign * df["Vf"].values, **plt_kw)
    ax.set_xlabel("Time / h")
    ax.set_ylabel("OCV / V")
    return ax


def plot_jv(df, area=None, plot_pwr=True, ax=None, pwr_kw=None, marker="o",
            **plt_kw):
    """j-V (and power) curves (reference: plotting.py:60-109)."""
    import matplotlib.pyplot as plt

    if pwr_kw is None:
        pwr_kw = {"marker": "o", "mfc": "white"}
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.5))
    i = np.abs(df["Im"].values)
    v = np.abs(df["Vf"].values)
    if area is not None:
        # convert current to current density (reference: plotting.py:68)
        i = i / area
    ax.plot(i, v, marker=marker, **plt_kw)
    ax.set_xlabel("$j$ / A$\\cdot$cm$^{-2}$" if area else "$I$ / A")
    ax.set_ylabel("$V$ / V")
    if plot_pwr:
        ax2 = ax.twinx()
        ax2.plot(i, i * v, color="gray", **pwr_kw)
        ax2.set_ylabel("$P$ / W" + ("$\\cdot$cm$^{-2}$" if area else ""))
    return ax
