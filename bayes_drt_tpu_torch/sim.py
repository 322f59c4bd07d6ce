"""Synthetic EIS data: analytic DRTs (ZARC, Gerischer, Havriliak-Negami),
circuit elements, the reference simulation circuits, the impedance of a
parallel DDT with a Cole-Cole distribution of diffusion times, and the
seeded noise models (copy of bayes_drt_tpu/sim.py, which this package may
not import; the DDT's diffusion impedance comes from ops/kernels.py on
the CPU, the Havriliak-Negami analytics are numpy copies of
bayes_drt_tpu/peaks.py:22-33)."""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels import get_zd_func


def zarc_drt(tau, t0, phi):
    """Analytical DRT of a ZARC element with unit resistance."""
    tau = np.asarray(tau, float)
    return ((1.0 / (2 * np.pi)) * np.sin((1 - phi) * np.pi)
            / (np.cosh(phi * np.log(tau / t0)) - np.cos((1 - phi) * np.pi)))


def gerischer_drt(tau, t0):
    """Analytical DRT of a Gerischer element with unit resistance."""
    tau = np.asarray(tau, float)
    out = np.zeros_like(tau)
    mask = tau < t0
    out[mask] = (1.0 / np.pi) * np.sqrt(tau[mask] / (t0 - tau[mask]))
    return out


def hn_drt(tau, t0, alpha, beta):
    """Analytical DRT of a Havriliak-Negami element (unit resistance).
    alpha=1: ZARC; beta=1: Cole-Davidson; alpha=0.5, beta=1: Gerischer."""
    tau = np.asarray(tau, float)
    r = (tau / t0) ** beta
    theta = np.arctan2(np.sin(np.pi * beta), r + np.cos(np.pi * beta))
    return ((1.0 / np.pi) * (tau / t0) ** (beta * alpha)
            * np.sin(alpha * theta)
            / (1.0 + 2.0 * np.cos(np.pi * beta) * r + r ** 2) ** (alpha / 2.0))


def z_rc(freq, R, tau):
    """Parallel RC: R / (1 + j w tau)."""
    omega = 2 * np.pi * np.asarray(freq, float)
    return R / (1 + 1j * omega * tau)


def z_zarc(freq, R, tau, phi):
    """ZARC (R parallel CPE): R / (1 + (j w tau)^phi)."""
    omega = 2 * np.pi * np.asarray(freq, float)
    return R / (1 + (1j * omega * tau) ** phi)


def z_gerischer(freq, R, t0):
    """Gerischer: R / sqrt(1 + j w t0)."""
    omega = 2 * np.pi * np.asarray(freq, float)
    return R / np.sqrt(1 + 1j * omega * t0)


def z_inductor(freq, L):
    omega = 2 * np.pi * np.asarray(freq, float)
    return 1j * omega * L


def z_hn(freq, R, t0, alpha, beta):
    """Havriliak-Negami element: R / (1 + (j w t0)^beta)^alpha."""
    omega = 2 * np.pi * np.asarray(freq, float)
    return R / (1.0 + (1j * omega * t0) ** beta) ** alpha


def cole_cole_rbf(y, epsilon):
    """Cole-Cole basis in numpy: sin(u) / (2 pi (cosh(eps y) - cos(u))),
    u = (1 - eps) pi."""
    u = (1.0 - epsilon) * np.pi
    return ((1.0 / (2.0 * np.pi)) * np.sin(u)
            / (np.cosh(epsilon * np.asarray(y, float)) - np.cos(u)))


def z_ddt_cole_cole(freq, t0, phi, bc="transmissive", symmetry="planar",
                    n_quad=2000, y_max=20.0):
    """Impedance of a parallel DDT with a Cole-Cole distribution of
    diffusion times centered at t0 (the reference's TP/BP-DDT simulations):
    Y(w) = int phi_cc(y) / Z_D(y, w, t0) dy, Z = 1/Y."""
    freq = np.asarray(freq, float)
    omega = 2 * np.pi * freq
    y = np.linspace(-y_max, y_max, n_quad)
    phi_y = cole_cole_rbf(y, phi)
    x = np.sqrt(1j * omega[:, None] * t0 * np.exp(y)[None, :])
    zd = get_zd_func(bc, symmetry)(torch.as_tensor(x)).numpy()
    Y = np.trapezoid(phi_y[None, :] / zd, y, axis=1)
    return 1.0 / Y


def add_simple_noise(Z, seed, scale, kind="uniform"):
    """Returns (Z_noisy, sigma_re, sigma_im). kind: uniform | proportional |
    modulus, with the reference's RandomState call pattern."""
    rs = np.random.RandomState(seed)
    rands = rs.normal(loc=0, size=(len(Z), 2), scale=scale)
    Z = np.copy(Z)
    if kind == "proportional":
        sigma_r = Z.real * scale
        sigma_i = Z.imag * scale
        Z = Z + rands[:, 0] * Z.real + 1j * rands[:, 1] * Z.imag
    elif kind == "modulus":
        mod = np.abs(Z)
        Z = Z + rands[:, 0] * mod + 1j * rands[:, 1] * mod
        sigma_r = mod * scale
        sigma_i = mod * scale
    elif kind == "uniform":
        Z = Z + rands[:, 0] + 1j * rands[:, 1]
        sigma_r = np.full(len(Z), scale)
        sigma_i = np.full(len(Z), scale)
    else:
        raise ValueError(f"Invalid kind {kind!r}")
    return Z, sigma_r, sigma_i


def add_model_noise(Z, seed, alpha, beta, model="Orazem"):
    """Orazem (sigma = a|Z'| + b|Z''|, shared) or Macdonald
    (sigma_r/i = a + b|Z'_/''|, distinct) structured noise, with the
    reference's RandomState call pattern."""
    rs = np.random.RandomState(seed)
    rands = rs.normal(loc=0, size=(len(Z), 2), scale=1)
    Z = np.copy(Z)
    if model == "Orazem":
        sigma = alpha * np.abs(Z.real) + beta * np.abs(Z.imag)
        Z = Z + rands[:, 0] * sigma + 1j * rands[:, 1] * sigma
        return Z, sigma, sigma
    if model == "Macdonald":
        sigma_r = alpha + beta * np.abs(Z.real)
        sigma_i = alpha + beta * np.abs(Z.imag)
        Z = Z + rands[:, 0] * sigma_r + 1j * rands[:, 1] * sigma_i
        return Z, sigma_r, sigma_i
    raise ValueError(f"Invalid model {model!r}")


def reference_circuit(name, freq):
    """Noiseless impedance of the named reference simulation circuit."""
    freq = np.asarray(freq, float)
    if name == "RC":
        return 1 + z_rc(freq, 1, 1e-2)
    if name == "ZARC":
        return 1 + z_zarc(freq, 1, 1e-3, 0.8)
    if name == "Gerischer":
        return 1 + z_gerischer(freq, 1, 1e-2)
    if name == "2RC":
        return 1 + z_rc(freq, 1, 1e-2) + z_rc(freq, 1, 1e-3)
    if name == "2ZARC":
        return 1 + z_zarc(freq, 1, 1e-2, 0.8) + z_zarc(freq, 1, 1e-3, 0.8)
    if name == "ZARC-RL":
        return (1 + z_zarc(freq, 1, 1e-2, 0.8)
                + z_zarc(freq, -0.2, (10 * 0.2) ** (1 / 0.9), 0.9))
    if name == "RC-ZARC":
        return z_rc(freq, 1, np.exp(-2)) + z_zarc(freq, 1, np.exp(2), 0.8)
    raise ValueError(f"Unknown reference circuit {name!r}")


def series_parallel_circuit(freq):
    """The Series-Parallel check spectrum: 1 + ZARC(1, 1e-3, 0.8) in series
    with a transmissive planar DDT whose diffusion times are Cole-Cole
    distributed at t0 = 0.1 with phi = 0.8. Its truths: the DRT part is
    zarc_drt(tau, 1e-3, 0.8), the DDT part cole_cole_rbf(ln(tau/0.1), 0.8)."""
    freq = np.asarray(freq, float)
    return (1 + z_zarc(freq, 1, 1e-3, 0.8)
            + z_ddt_cole_cole(freq, 0.1, 0.8, bc="transmissive"))


def reference_gamma(name, tau):
    """Analytic DRT of the named reference circuit (None for pure-RC
    delta-function circuits)."""
    tau = np.asarray(tau, float)
    if name == "ZARC":
        return zarc_drt(tau, 1e-3, 0.8)
    if name == "Gerischer":
        return gerischer_drt(tau, 1e-2)
    if name == "2ZARC":
        return zarc_drt(tau, 1e-2, 0.8) + zarc_drt(tau, 1e-3, 0.8)
    if name == "ZARC-RL":
        return (zarc_drt(tau, 1e-2, 0.8)
                - 0.2 * zarc_drt(tau, (10 * 0.2) ** (1 / 0.9), 0.9))
    if name == "RC-ZARC":
        return zarc_drt(tau, np.exp(2), 0.8)
    return None


def noisy_replicas(Z, n_spectra, noise_level=0.0025, seed=0):
    """(n_spectra, N) noisy replicas of the spectrum ``Z``: uniform noise
    at ``noise_level`` of its real range, one RandomState seed a replica
    drawn from ``seed``."""
    z_range = np.max(Z.real) - np.min(Z.real)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_spectra):
        Zn, _, _ = add_simple_noise(Z, rng.randint(1 << 31),
                                    noise_level * z_range, "uniform")
        out.append(Zn)
    return np.stack(out)


def make_benchmark_batch(n_spectra, freq=None, circuit="ZARC",
                         noise_level=0.0025, seed=0):
    """A batch of noisy replicas of a reference circuit. Returns
    (freq, Z_batch (B, N))."""
    if freq is None:
        freq = np.logspace(6, -2, 81)
    Z = reference_circuit(circuit, freq)
    return freq, noisy_replicas(Z, n_spectra, noise_level, seed)


def make_ragged_fleet(n_spectra, seed=0):
    """ZARC spectra measured on different grids, the recipe of the JAX
    package's ragged benchmark: per spectrum ppd in {8, 10, 12}, the span
    10^6..10^-2 Hz shortened by up to a decade at each end, complex noise
    at 0.25% of |Z|. Returns a list of (freq, Z) pairs."""
    rng = np.random.default_rng(seed)
    spectra = []
    for _ in range(n_spectra):
        ppd = rng.choice([8, 10, 12])
        lo = -2 + rng.uniform(0, 1.0)
        hi = 6 - rng.uniform(0, 1.0)
        n = int((hi - lo) * ppd) + 1
        freq = np.logspace(hi, lo, n)
        Z = reference_circuit("ZARC", freq)
        sigma = 0.0025 * np.abs(Z)
        Z = Z + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        spectra.append((freq, Z))
    return spectra


def make_drift_fleet(n_cells, seed=0):
    """Cells on one three-sweep schedule drifting by a growing ZARC, the
    recipe of the JAX package's drift benchmark: 31 frequencies
    10^5..10^-1 Hz swept three times over 5400 s (N = 93), each cell
    1 + ZARC(1, 1e-3, 0.85) plus (1 - e^{-t/tau_d}) ZARC(s, 0.05, 0.9)
    with s ~ U(0.2, 0.8) and tau_d ~ U(400, 1200) s, complex noise at
    0.001. Returns (freq, times, Z (n_cells, N))."""
    rng = np.random.default_rng(seed)
    base_freq = np.logspace(5, -1, 31)
    freq = np.tile(base_freq, 3)
    times = np.linspace(0, 3 * 1800.0, len(freq))
    omega = 2 * np.pi * freq
    scales = rng.uniform(0.2, 0.8, n_cells)
    taus_d = rng.uniform(400.0, 1200.0, n_cells)
    Zb = []
    for s, td in zip(scales, taus_d):
        z = 1.0 + 1.0 / (1 + (1j * omega * 1e-3) ** 0.85) \
            + (1 - np.exp(-times / td)) * (s / (1 + (1j * omega * 0.05)
                                                ** 0.9))
        z += 0.001 * (rng.standard_normal(len(z))
                      + 1j * rng.standard_normal(len(z)))
        Zb.append(z)
    return freq, times, np.array(Zb)


def make_drifting_spectrum(model="RQ", seed=0):
    """One spectrum drifting by a growing ZARC(0.5, 0.05, 0.9) at rate
    1/600 s, measured over three consecutive 31-point sweeps (drift is
    identifiable only where a frequency is revisited), the JAX package's
    drift test spectrum. Returns (freq, Z, times)."""
    rng = np.random.default_rng(seed)
    base_freq = np.logspace(5, -1, 31)
    freq = np.tile(base_freq, 3)
    times = np.linspace(0, 3 * 1800.0, len(freq))
    omega = 2 * np.pi * freq
    z_static = 1.0 + 1.0 / (1 + (1j * omega * 1e-3) ** 0.85)
    if model.startswith("RQ"):
        f_t = 1 - np.exp(-(1.0 / 600.0) * times)     # rate k_d
    else:
        f_t = 1 - np.exp(-times / 600.0)             # time constant
    Z = z_static + f_t * (0.5 / (1 + (1j * omega * 0.05) ** 0.9))
    Z = Z + 0.001 * (rng.standard_normal(len(Z))
                     + 1j * rng.standard_normal(len(Z)))
    return freq, Z, times


def write_gamry_dta(path, freq, Z, start="03/15/2021 14:30:00"):
    """Write a spectrum as a Gamry EXPLAIN (.DTA) potentiostatic EIS file:
    the header tags (DATE and TIME of ``start``, "%m/%d/%Y %H:%M:%S"), the
    ZCURVE table's tab-separated header and units lines (Latin-1, with the
    degree sign) and one row per frequency, each led by a tab. This is
    the layout the C++ loader (native/loader.cpp) and io.read_eis parse;
    the numbers are written by their repr."""
    freq = np.asarray(freq, float)
    Z = np.asarray(Z)
    date, time = start.split(" ")
    cols = ("Pt", "Time", "Freq", "Zreal", "Zimag", "Zsig", "Zmod", "Zphz",
            "Idc", "Vdc", "IERange")
    units = ("#", "s", "Hz", "ohm", "ohm", "V", "ohm", "°", "A", "V",
             "#")
    lines = ["EXPLAIN", "TAG\tEISPOT",
             "TITLE\tLABEL\tPotentiostatic EIS\tTest &Identifier",
             f"DATE\tLABEL\t{date}\tDate", f"TIME\tLABEL\t{time}\tTime",
             "ZCURVE\tTABLE", "\t" + "\t".join(cols),
             "\t" + "\t".join(units)]
    for i, (f, z) in enumerate(zip(freq, Z)):
        row = (i, float(i), f, z.real, z.imag, 1.0, abs(z),
               float(np.degrees(np.arctan2(z.imag, z.real))), 0.0, 0.0, 5)
        lines.append("\t" + "\t".join(repr(float(v)) if isinstance(v, float)
                                      else str(v) for v in row))
    with open(path, "w", encoding="latin1", newline="\r\n") as fh:
        fh.write("\n".join(lines) + "\n")
