"""Synthetic EIS data: analytic DRTs, the reference simulation circuits,
the impedance of a parallel DDT with a Cole-Cole distribution of diffusion
times, and the seeded uniform noise model of the benchmark batches (copy of
bayes_drt_tpu/sim.py, which this package may not import; the DDT's
diffusion impedance comes from ops/kernels.py on the CPU)."""

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
