"""Numeric utilities (copy of bayes_drt_tpu/utils.py, which this package
may not import): host-side numpy helpers for grid equality, outlier
thresholds, R^2 and the plotting unit scales."""

from __future__ import annotations

import numpy as np


def rel_round(x, precision: int):
    """Round to ``precision`` significant digits relative to each element's scale.

    Used for float-tolerant equality checks on frequency grids
    (reference: utils.py:113-131).
    """
    x = np.asarray(x, dtype=float)
    scale = np.floor(np.log10(np.abs(x) + 1e-30))
    factor = 10.0 ** (precision - scale)
    return np.round(x * factor) / factor


def is_loguniform(frequencies) -> bool:
    """True if frequencies are (approximately) uniformly spaced in log space
    (reference: utils.py:134-140)."""
    fdiff = np.diff(np.log(np.asarray(frequencies, dtype=float)))
    if len(fdiff) == 0:
        return True
    m = np.mean(fdiff)
    if m == 0:
        return False
    return bool(np.std(fdiff) / np.abs(m) <= 0.01)


def check_equality(a, b) -> bool:
    """Equality for nested dicts/arrays (reference: utils.py:93-110)."""
    try:
        np.testing.assert_equal(a, b)
        return True
    except AssertionError:
        return False


def get_outlier_thresh(y, iqr_factor: float = 3.0) -> float:
    """IQR-based outlier threshold (reference: utils.py:143-146)."""
    y = np.asarray(y, dtype=float)
    q75, q25 = np.percentile(y, 75), np.percentile(y, 25)
    return q75 + iqr_factor * (q75 - q25)


def r2_score(y, y_hat, weights=None) -> float:
    """Coefficient of determination (reference: utils.py:149-165)."""
    y = np.asarray(y, dtype=float)
    y_hat = np.asarray(y_hat, dtype=float)
    if weights is None:
        ss_res = np.sum((y_hat - y) ** 2)
        ss_tot = np.sum((y - np.mean(y)) ** 2)
    else:
        weights = np.asarray(weights, dtype=float)
        ss_res = np.sum(weights * (y_hat - y) ** 2)
        ss_tot = np.sum(weights * (y - np.average(y, weights=weights)) ** 2)
    return 1.0 - ss_res / ss_tot


# --- unit-scale helpers for plotting (reference: utils.py:8-49) ---

_UNIT_MAP = {-2: "$\\mu$", -1: "m", 0: "", 1: "k", 2: "M", 3: "G"}


def get_unit_scale(df, area=None) -> str:
    if area is None:
        area = 1
    z_max = max(df["Zreal"].max(), df["Zimag"].abs().max()) * area
    z_ord = int(np.floor(np.log10(z_max) / 3))
    return _UNIT_MAP.get(z_ord, "")


def get_scale_factor(df, area=None) -> float:
    if area is None:
        area = 1
    z_max = max(df["Zreal"].max(), df["Zimag"].abs().max()) * area
    z_ord = np.floor(np.log10(z_max) / 3)
    return 10.0 ** (3 * z_ord)


def get_factor_from_unit(unit_scale: str) -> float:
    pwr_map = {v: k for k, v in _UNIT_MAP.items()}
    return 10.0 ** (3 * pwr_map[unit_scale])


def get_common_unit_scale(df_list, aggregate: str = "min") -> str:
    rev_map = {v: k for k, v in _UNIT_MAP.items()}
    nums = [rev_map[get_unit_scale(df)] for df in df_list]
    common = getattr(np, aggregate)(nums)
    return _UNIT_MAP.get(int(common), "")


def polar_from_complex(z):
    z = np.asarray(z)
    zmod = np.abs(z)
    zphz = np.degrees(np.arctan(z.imag / z.real))
    return zmod, zphz


def complex_from_polar(zmod, zphz_deg):
    phase = np.radians(np.asarray(zphz_deg, dtype=float))
    zmod = np.asarray(zmod, dtype=float)
    return zmod * np.cos(phase), zmod * np.sin(phase)


def is_number(s):
    """True if ``s`` parses as a float (reference: utils.py:79-84)."""
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def camel_case_split(identifier):
    """Split a CamelCase identifier into words (reference: utils.py:87-90)."""
    import re
    matches = re.finditer(
        ".+?(?:(?<=[a-z])(?=[A-Z0-9])|(?<=[A-Z0-9])(?=[A-Z0-9][a-z])|$)",
        identifier)
    return [m.group(0) for m in matches]
