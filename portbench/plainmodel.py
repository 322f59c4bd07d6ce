"""The plain reference posterior: the calibrated hierarchical model of the
reference package's Stan programs (series and parallel DRT / DDT
distributions, ``nonneg``, non-centered coefficients), written out in
plain PyTorch and numpy for the benchmark's checks.

It is a frozen, self-contained restatement of the model: the impedance
matrices by the trapezoid rule on y in [-20, 20] with 1000 nodes, the
derivative matrices of the Gaussian basis, the mode's penalty scalings and
hyperparameters, the Z-scale rule and the log density. It imports nothing
of the program. It reads the program's flat parameter vectors in their
layout (the Stan parameters sorted by name), as it reads any other output
of the program.

``precision="tf32"`` is the control: the same computation in float32
with every matrix product's operands rounded to TF32 (10 mantissa bits),
the precision one step below the float32 that the configurations state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# (L0, L1, L2) multipliers by mode and the distribution's role
_L_SCALES = {
    ("optimize", "single"): (1.5 * 0.24, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "single"): (1.0, 1.0, 0.75),
    ("optimize", "series"): (1.5 * 0.24, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "series"): (1.0, 1.0, 0.75),
    ("optimize", "parallel"): (1.5 * 0.36, 1.5 * 0.16, 1.5 * 0.08),
    ("sample", "parallel"): (1.0, 1.0, 0.75),
}


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    r = ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tau_basis(freq, ppd=10):
    """Basis time constants: ``ppd`` a decade over the measured range
    extended by a decade at each end."""
    freq = np.asarray(freq, float)
    tmin = np.log10(1.0 / (2.0 * np.pi * freq.max())) - 1.0
    tmax = np.log10(1.0 / (2.0 * np.pi * freq.min())) + 1.0
    return np.logspace(tmin, tmax, int(ppd * (tmax - tmin) + 1))


def basis_epsilon(tau):
    """Inverse length scale of the Gaussian basis: 1 / mean ln-tau step."""
    return float(1.0 / np.mean(np.diff(np.log(np.asarray(tau, float)))))


def gaussian(y, eps):
    return np.exp(-((eps * y) ** 2))


def _quad_nodes(n=1000, y_max=20.0):
    y = np.linspace(-y_max, y_max, n)
    w = np.full(n, 2.0 * y_max / (n - 1))
    w[0] = w[-1] = w[0] / 2
    return y, w


def drt_matrix(freq, tau, eps):
    """(2N, K) [A'; A''] of a series DRT: int phi(y) K(y + ln(w tau)) dy,
    K' = 1 / (1 + e^{2u}), K'' = -sech(u) / 2."""
    y, w = _quad_nodes()
    s = np.log(2 * np.pi * np.asarray(freq)[:, None] * tau[None, :])
    u = y[None, None, :] + s[:, :, None]
    phiw = gaussian(y, eps) * w
    re = (1.0 / (1.0 + np.exp(2.0 * np.clip(u, -40.0, 40.0)))) @ phiw
    e = np.exp(-np.abs(u))
    im = (-e / (1.0 + e * e)) @ phiw
    return np.concatenate([re, im])


def ddt_parallel_matrix(freq, tau, eps):
    """(2N, K) [A'; A''] of a parallel transmissive planar DDT in
    admittance units: int phi(y) x / tanh(x) dy, x = sqrt(j w tau e^y)
    (tanh(x)/x by its series where |x^2| < 0.03)."""
    y, w = _quad_nodes()
    omega = 2 * np.pi * np.asarray(freq)
    x = np.sqrt(1j * omega[:, None, None] * tau[None, :, None]
                * np.exp(y)[None, None, :])
    z = x * x
    small = np.abs(z) < 0.03
    coef = (1.0, -1.0 / 3.0, 2.0 / 15.0, -17.0 / 315.0, 62.0 / 2835.0,
            -1382.0 / 155925.0, 21844.0 / 6081075.0)
    series = np.full_like(z, coef[-1])
    for c in coef[-2::-1]:
        series = series * z + c
    xs = np.where(small, 1.0, x)
    zd = np.where(small, series,
                  np.tanh(np.clip(xs.real, -30, 30) + 1j * xs.imag) / xs)
    a = (1.0 / zd) @ (gaussian(y, eps) * w)
    return np.concatenate([a.real, a.imag])


def derivative_matrices(tau, eps):
    """(3, K, K): orders 0, 1, 2 of the Gaussian basis in y at the
    collocation points tau_n: y = ln(tau_n / tau_m)."""
    y = np.log(tau[:, None] / tau[None, :])
    e2 = eps * eps
    g = np.exp(-e2 * y * y)
    return np.stack([g, -2.0 * e2 * y * g,
                     (-2.0 * e2 + 4.0 * e2 * e2 * y * y) * g])


class Grid:
    """A configuration's grids without its matrices: the frequencies
    (descending), the distributions in the posterior's order (series,
    then parallel, each by name), each one's basis ``tau`` and ``eps``,
    and the flat layout's width ``D``."""

    def __init__(self, freq, dists):
        self.freq = np.sort(np.asarray(freq, float))[::-1]
        self.n = len(self.freq)
        order = (sorted(d["name"] for d in dists if d["dist_type"] == "series")
                 + sorted(d["name"] for d in dists
                          if d["dist_type"] == "parallel"))
        by_name = {d["name"]: d for d in dists}
        self.dists = [by_name[nm] for nm in order]
        self.tau, self.eps = [], []
        for d in self.dists:
            if "basis_freq" in d:
                hi, lo, m = d["basis_freq"]
                tau = 1.0 / (2 * np.pi * np.logspace(hi, lo, int(m)))
            else:
                tau = tau_basis(self.freq)
            self.tau.append(tau)
            self.eps.append(basis_epsilon(tau))
        self.layout = self._layout()
        self.D = sum(s for _, s in self.layout)

    def _layout(self):
        sizes = {}
        for i, tau in enumerate(self.tau):
            sizes[f"x_{i}"] = len(tau)
            sizes[f"ups_raw_{i}"] = len(tau)
            sizes[f"d_strength_{i}"] = 3
        for nm in ("Rinf_raw", "induc_raw", "sigma_res_raw",
                   "alpha_prop_raw", "alpha_re_raw", "alpha_im_raw"):
            sizes[nm] = 1
        return sorted(sizes.items())


class Model(Grid):
    """One configuration's posterior on one frequency grid.

    ``dists``: the configuration's distributions, each {'name', 'kernel'
    ('DRT' or 'DDT'), 'dist_type' ('series' or 'parallel'), optional
    'basis_freq' [hi, lo, n] (log10 decades, points) and 'x_scale'}.
    ``mode``: 'sample' or 'optimize'."""

    def __init__(self, freq, dists, mode="sample", nonneg=False, ncp=False,
                 sigma_min=0.002, device="cpu", precision="exact"):
        super().__init__(freq, dists)
        self.mode, self.nonneg, self.ncp = mode, nonneg, ncp
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "exact" else torch.float32
        single = len(self.dists) == 1
        A, L, xs = [], [], []
        for d, tau, eps in zip(self.dists, self.tau, self.eps):
            if d["kernel"] == "DRT":
                a = drt_matrix(self.freq, tau, eps)
            else:
                a = ddt_parallel_matrix(self.freq, tau, eps)
            scales = _L_SCALES[(mode, "single" if single
                                else d["dist_type"])]
            lm = derivative_matrices(tau, eps) * np.array(scales)[:, None,
                                                                   None]
            A.append(self._t(a))
            L.append(self._t(lm))
            xs.append(d.get("x_scale", 1.0) if d["dist_type"] == "parallel"
                      else 1.0)
        self.A, self.L, self.x_scales = A, L, xs
        self.sigma_min = sigma_min
        self.ups_alpha, self.ups_beta = ((1.0, 0.1) if mode == "sample"
                                         else (0.05, 0.1))
        self.x_sum_invscale = (1.0 if mode == "sample"
                               and len(self.dists) == 2 else 0.0)

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)

    def mm(self, a, b):
        if self.precision == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def unravel(self, q):
        out, off = {}, 0
        for nm, s in self.layout:
            v = q[..., off:off + s]
            out[nm] = v[..., 0] if s == 1 else v
            off += s
        return out

    def z_scales(self, Z):
        """Per spectrum std|Z| / sqrt(N / 81)."""
        return np.std(np.abs(Z), axis=-1) / np.sqrt(Z.shape[-1] / 81)

    def targets(self, Z):
        """Scaled stacked [Z' | Z''] rows (B, 2N) on the model's grid (the
        spectra's columns follow descending frequency) and the scales."""
        zs = self.z_scales(Z)
        Zs = Z / zs[:, None]
        return self._t(np.concatenate([Zs.real, Zs.imag], axis=1)), zs

    def _positive(self, i):
        return self.dists[i]["dist_type"] == "parallel" or self.nonneg

    def constrain(self, p):
        c = {"Rinf": torch.exp(p["Rinf_raw"]) * 100.0,
             "induc": torch.exp(p["induc_raw"])}
        for i in range(len(self.dists)):
            ups = torch.exp(p[f"ups_raw_{i}"]) * 0.15
            c[f"ups_{i}"] = ups
            c[f"d_{i}"] = torch.exp(p[f"d_strength_{i}"])
            u = p[f"x_{i}"]
            base = torch.exp(u) if self._positive(i) else u
            c[f"x_raw_{i}"] = base * ups if self.ncp else base
            c[f"x_{i}"] = c[f"x_raw_{i}"] * self.x_scales[i]
        for nm in ("sigma_res", "alpha_prop", "alpha_re", "alpha_im"):
            c[nm] = torch.exp(p[nm + "_raw"]) * 0.05
        return c

    def predict(self, c):
        """Stacked prediction (..., 2N) in scaled units."""
        n = self.n
        pred = 0.0
        for i, d in enumerate(self.dists):
            t = self.mm(c[f"x_{i}"], self.A[i].T)
            if d["dist_type"] == "parallel":
                den = t[..., :n] ** 2 + t[..., n:] ** 2
                t = torch.cat([t[..., :n] / den, -t[..., n:] / den], dim=-1)
            pred = pred + t
        w = torch.as_tensor(2 * np.pi * self.freq, dtype=self.dtype,
                            device=self.device)
        one, zero = torch.ones_like(w), torch.zeros_like(w)
        return (pred + c["Rinf"][..., None] * torch.cat([one, zero])
                + c["induc"][..., None] * torch.cat([zero, w]))

    def log_density(self, q, target, jacobian=True):
        """log p(q | data) of rows q (R, D) against target rows (R, 2N):
        jacobian=True on the unconstrained space (the samplers' measure),
        False the optimizing objective's negative."""
        p = self.unravel(q)
        c = self.constrain(p)
        lp = 0.0
        if jacobian:
            for nm, s in self.layout:
                if nm.startswith("x_") and not self._positive(int(nm[2:])):
                    continue
                v = p[nm]
                lp = lp + (v.sum(-1) if v.ndim == q.ndim else v)
            if self.ncp:
                for i in range(len(self.dists)):
                    lp = lp + torch.log(c[f"ups_{i}"]).sum(-1)

        def half_normal(nm):
            e = torch.exp(p[nm])
            return -0.5 * e * e - _LOG_SQRT_2PI

        for nm in ("Rinf_raw", "induc_raw", "sigma_res_raw",
                   "alpha_prop_raw", "alpha_re_raw", "alpha_im_raw"):
            lp = lp + half_normal(nm)
        xsum = 0.0
        for i in range(len(self.dists)):
            ds = c[f"d_{i}"]
            lp = lp + (5.0 * math.log(5.0) - math.lgamma(5.0)
                       - 6.0 * torch.log(ds) - 5.0 / ds).sum(-1)
            ue = torch.exp(p[f"ups_raw_{i}"])
            a, b = self.ups_alpha, self.ups_beta
            lp = lp + (a * math.log(b) - math.lgamma(a)
                       - (a + 1.0) * torch.log(ue) - b / ue).sum(-1)
            xr = c[f"x_raw_{i}"]
            L = self.L[i]
            qq = torch.sqrt(ds[..., 0:1] * self.mm(xr, L[0].T) ** 2
                            + ds[..., 1:2] * self.mm(xr, L[1].T) ** 2
                            + ds[..., 2:3] * self.mm(xr, L[2].T) ** 2)
            ups = c[f"ups_{i}"]
            zq = qq / ups
            lp = lp + (-0.5 * zq * zq - torch.log(ups) - _LOG_SQRT_2PI).sum(-1)
            dups = (0.5 * (ups[..., 1:-1] - 0.5 * (ups[..., :-2]
                                                   + ups[..., 2:]))
                    / ups[..., 1:-1])
            lp = lp + (-0.5 * dups * dups - _LOG_SQRT_2PI).sum(-1)
            xsum = xsum + xr.sum(-1)
        if len(self.dists) > 1:
            v = xsum * self.x_sum_invscale
            lp = lp - 0.5 * v * v - _LOG_SQRT_2PI
        pred = self.predict(c)
        n = self.n
        pre, pim = pred[..., :n].tile(2), pred[..., n:].tile(2)
        var = (self.sigma_min ** 2 + c["sigma_res"][..., None] ** 2
               + (c["alpha_prop"][..., None] * pred) ** 2
               + (c["alpha_re"][..., None] * pre) ** 2
               + (c["alpha_im"][..., None] * pim) ** 2)
        st = torch.sqrt(var)
        z = (target - pred) / st
        return lp + (-0.5 * z * z - torch.log(st) - _LOG_SQRT_2PI).sum(-1)

    def value_and_grad(self, q, target, jacobian=True, rows=4096):
        """(log density (R,), gradient (R, D)) in the model's precision,
        by autograd, ``rows`` rows at a time."""
        lps, gs = [], []
        for i in range(0, q.shape[0], rows):
            x = q[i:i + rows].to(self.device, self.dtype).detach()
            x.requires_grad_(True)
            with torch.enable_grad():
                lp = self.log_density(x, target[i:i + rows], jacobian)
                (g,) = torch.autograd.grad(lp.sum(), x)
            lps.append(lp.detach())
            gs.append(g)
        return torch.cat(lps), torch.cat(gs)

    def basis(self, i, eval_tau):
        """(M, K) Gaussian basis of distribution i at ``eval_tau``."""
        y = np.log(np.asarray(eval_tau, float)[:, None]
                   / self.tau[i][None, :])
        return self._t(gaussian(y, self.eps[i]))

    def gamma(self, i, coef, eval_tau):
        """(B, M) distribution i at ``eval_tau`` from (B, K) coefficients."""
        c = torch.as_tensor(np.asarray(coef), dtype=self.dtype,
                            device=self.device)
        return self.mm(c, self.basis(i, eval_tau).T)

    def z_series(self, coef, r_inf, induc):
        """(B, 2N) stacked impedance of a series-only model at coefficients
        (B, K), R_inf (B,) and inductance (B,), in physical units."""
        c = torch.as_tensor(np.asarray(coef), dtype=self.dtype,
                            device=self.device)
        w = torch.as_tensor(2 * np.pi * self.freq, dtype=self.dtype,
                            device=self.device)
        ri = torch.as_tensor(np.asarray(r_inf), dtype=self.dtype,
                             device=self.device)
        li = torch.as_tensor(np.asarray(induc), dtype=self.dtype,
                             device=self.device)
        z = self.mm(c, self.A[0].T)
        n = self.n
        return torch.cat([z[:, :n] + ri[:, None],
                          z[:, n:] + li[:, None] * w[None, :]], dim=1)


def from_config(config, mode, device, precision="exact"):
    """The posterior of a configuration file's model in ``mode``: sampling
    in the configuration's parameterization, the optimizing objective
    (Stan's, in the centered parameters) for 'optimize'."""
    return Model(np.logspace(*config["freq"]), config["distributions"],
                 mode=mode, nonneg=config["nonneg"],
                 ncp=config["ncp"] and mode == "sample",
                 sigma_min=config["sigma_min"], device=device,
                 precision=precision)
