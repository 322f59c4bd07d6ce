"""The JAX package's ridge seed of a single parallel distribution
(bayes_drt_tpu/parallel/batch.py:551-588): one JAX Inverter admittance
ridge a spectrum, scaled into the posterior's coordinates, for holding
the port's seed to it."""

import numpy as np

from bayes_drt_tpu import Inverter as JaxInverter
from bayes_drt_tpu.models.build import z_scale_for


def jax_parallel_ridge_seed(freq, zb, distributions, ridge_kw=None,
                            outliers=False):
    """init values (x_0, Rinf_raw, induc_raw[, sigma_out_raw]) of the
    spectra ``zb`` (B, N) on ``freq``, rows in the spectra's order and the
    points in descending frequency."""
    # the batch's defaults of a DDT (parallel, planar, blocking)
    distributions = {k: dict(v) for k, v in distributions.items()}
    for info in distributions.values():
        info.setdefault("dist_type", "parallel")
        info.setdefault("symmetry", "planar")
        info.setdefault("bc", "blocking")
    order = np.argsort(np.asarray(freq, float))[::-1]
    freq = np.asarray(freq, float)[order]
    zb = np.asarray(zb)[:, order]
    name0 = list(distributions)[0]
    z_scales = np.atleast_1d(z_scale_for(distributions, zb, fit_type="map"))
    rkw = dict(penalty="integral", hyper_lambda=True, lambda_0=1.0,
               hl_beta=5, weights="modulus")
    rkw.update(ridge_kw or {})
    inv = JaxInverter(distributions=distributions)
    out = {"x_0": [], "Rinf_raw": [], "induc_raw": [], "sigma_out_raw": []}
    for i in range(len(zb)):
        inv.ridge_fit(freq, zb[i], **rkw)
        out["x_0"].append(inv.distribution_fits[name0]["coef"]
                          * z_scales[i])
        out["Rinf_raw"].append(max(float(inv.R_inf) / z_scales[i], 1e-10)
                               / 100.0)
        out["induc_raw"].append(max(float(inv.inductance) / z_scales[i],
                                    1e-10))
        if outliers:
            flagged = inv.check_outliers(freq, zb[i], threshold=3,
                                         use_existing_fit=True)
            sig = np.full(len(freq), 0.1)
            sig[np.asarray(flagged).ravel()] = 1.0
            out["sigma_out_raw"].append(sig)
    if not outliers:
        del out["sigma_out_raw"]
    return {k: np.asarray(v) for k, v in out.items()}
