"""The benchmark's input generators and analytic truths: a frozen copy of
the parts of the port's ``sim`` module that the cells use, so that an
edit of the program cannot move the yardstick.

Everything here is numpy on the host. ``stream`` derives every random
stream of a run from its ``--seed`` (any non-negative integer, larger
than 32 bits too)."""

from __future__ import annotations

import numpy as np


# the streams of a run: the noisy batches of its pool, the warm-up fit's
# sampler seed, each timed fit's sampler seed
POOL, WARMUP, FIT = 0, 1, 2


def stream(seed: int, tag: int, i: int) -> int:
    """The ``i``-th 31-bit seed of stream ``tag`` of the run ``seed``."""
    ss = np.random.SeedSequence(int(seed), spawn_key=(int(tag), int(i)))
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


def zarc_drt(tau, t0, phi):
    """Analytic DRT of a ZARC element with unit resistance."""
    tau = np.asarray(tau, float)
    return ((1.0 / (2 * np.pi)) * np.sin((1 - phi) * np.pi)
            / (np.cosh(phi * np.log(tau / t0)) - np.cos((1 - phi) * np.pi)))


def cole_cole_rbf(y, epsilon):
    """Cole-Cole distribution: sin(u) / (2 pi (cosh(eps y) - cos(u))),
    u = (1 - eps) pi."""
    u = (1.0 - epsilon) * np.pi
    return ((1.0 / (2.0 * np.pi)) * np.sin(u)
            / (np.cosh(epsilon * np.asarray(y, float)) - np.cos(u)))


def z_zarc(freq, R, tau, phi):
    """ZARC: R / (1 + (j w tau)^phi)."""
    omega = 2 * np.pi * np.asarray(freq, float)
    return R / (1 + (1j * omega * tau) ** phi)


# tanh(x)/x = sum c_k z^k, z = x^2, for small |z|
_TANH_COEF = (1.0, -1.0 / 3.0, 2.0 / 15.0, -17.0 / 315.0, 62.0 / 2835.0,
              -1382.0 / 155925.0, 21844.0 / 6081075.0)
_SMALL_Z = 0.03


def zd_transmissive_planar(x):
    """Diffusion impedance tanh(x)/x of complex ``x``, by its series where
    |x^2| < 0.03 and with the real part clipped to +-30 in tanh."""
    x = np.asarray(x, complex)
    z = x * x
    small = np.abs(z) < _SMALL_Z
    series = np.full_like(z, _TANH_COEF[-1])
    for c in _TANH_COEF[-2::-1]:
        series = series * z + c
    xs = np.where(small, 1.0, x)
    t = np.tanh(np.clip(xs.real, -30.0, 30.0) + 1j * xs.imag)
    return np.where(small, series, t / xs)


def z_ddt_cole_cole(freq, t0, phi, n_quad=2000, y_max=20.0):
    """Impedance of a transmissive planar parallel DDT whose diffusion
    times are Cole-Cole distributed at ``t0``: Y = int phi_cc(y) / Z_D dy
    on a trapezoid grid, Z = 1 / Y."""
    omega = 2 * np.pi * np.asarray(freq, float)
    y = np.linspace(-y_max, y_max, n_quad)
    x = np.sqrt(1j * omega[:, None] * t0 * np.exp(y)[None, :])
    zd = zd_transmissive_planar(x)
    Y = np.trapezoid(cole_cole_rbf(y, phi)[None, :] / zd, y, axis=1)
    return 1.0 / Y


def element(spec, freq):
    """Noiseless impedance of one circuit element: {'kind': 'zarc', 'R',
    't0', 'phi'} or {'kind': 'ddt_cole_cole', 't0', 'phi'} (a transmissive
    planar parallel DDT whose diffusion times are Cole-Cole distributed)."""
    if spec["kind"] == "zarc":
        return z_zarc(freq, spec["R"], spec["t0"], spec["phi"])
    if spec["kind"] == "ddt_cole_cole":
        return z_ddt_cole_cole(freq, spec["t0"], spec["phi"])
    raise ValueError(f"unknown circuit element {spec['kind']!r}")


def circuit(spec, freq):
    """Noiseless impedance of a configuration's ``circuit``: {'r_inf', the
    series resistance, 'elements': [element specs]}, the elements in
    series, added in their order."""
    freq = np.asarray(freq, float)
    z = spec["r_inf"]
    for e in spec["elements"]:
        z = z + element(e, freq)
    return z


def truth(spec, tau):
    """An analytic distribution on ``tau``: {'kind': 'zarc', 't0', 'phi'}
    or {'kind': 'cole_cole', 't0', 'phi'} (in ln(tau / t0))."""
    tau = np.asarray(tau, float)
    if spec["kind"] == "zarc":
        return zarc_drt(tau, spec["t0"], spec["phi"])
    if spec["kind"] == "cole_cole":
        return cole_cole_rbf(np.log(tau / spec["t0"]), spec["phi"])
    raise ValueError(f"unknown truth {spec['kind']!r}")


def truths(config, taus):
    """A configuration's analytic distributions (its ``truth`` list), each
    on the basis grid of its distribution."""
    return [truth(t, tau) for t, tau in zip(config["truth"], taus)]


def noisy_replicas(Z, n_spectra, noise_level=0.0025, seed=0):
    """(n_spectra, N) replicas of ``Z`` with uniform complex Gaussian noise
    at ``noise_level`` of its real range, one RandomState a replica seeded
    from a RandomState of ``seed`` (the reference's call pattern)."""
    scale = noise_level * (np.max(Z.real) - np.min(Z.real))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_spectra):
        rs = np.random.RandomState(rng.randint(1 << 31))
        r = rs.normal(loc=0, size=(len(Z), 2), scale=scale)
        out.append(Z + r[:, 0] + 1j * r[:, 1])
    return np.stack(out)
