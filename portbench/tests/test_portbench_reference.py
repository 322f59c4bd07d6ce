"""The plain reference against the port's own eager CPU path, in float64
at small sizes: A and L, the Z scales and targets, the log density and
its gradient (sampling, non-centered), the optimizing objective, and the
basis that gamma is read through."""

import numpy as np
import pytest
import torch

from bayes_drt_tpu_torch.models.posterior import (init_unconstrained,
                                                  posterior_value_and_grad,
                                                  ravel)
from bayes_drt_tpu_torch.parallel import batch
from portbench import gen
from portbench.tests.cpu_cells import load_config
from portbench.plainmodel import Model

FREQ = np.logspace(4, -1, 26)
SP = [{"name": "DRT", "kernel": "DRT", "dist_type": "series",
       "basis_freq": [4.2, -1.2, 19]},
      {"name": "TP-DDT", "kernel": "DDT", "dist_type": "parallel",
       "symmetry": "planar", "bc": "transmissive",
       "basis_freq": [4.2, -1.2, 19], "x_scale": 0.8}]
ZARC = [{"name": "DRT", "kernel": "DRT", "dist_type": "series"}]
CASES = {"zarc_series": (ZARC, False, "zarc_series"),
         "sp_drt_ddt": (SP, True, "sp_drt_ddt")}


def port_side(dists, nonneg, ncp, mode):
    kw = dict(nonneg=nonneg, sigma_min=0.002, dtype=torch.float64,
              device="cpu", mode=mode)
    if any("basis_freq" in d for d in dists):
        kw["distributions"] = {
            d["name"]: {**{k: v for k, v in d.items()
                           if k not in ("name", "basis_freq")},
                        "basis_freq": np.logspace(*d["basis_freq"])}
            for d in dists}
    f, tau, eps, cfg, data, dn = batch._build_shared(FREQ, ncp=ncp, **kw)
    return f, tau, eps, cfg, data, dn


def spectra(config, b=3, seed=5):
    """Noisy spectra of the named configuration's circuit."""
    z = gen.circuit(load_config(config)["circuit"], FREQ)
    return gen.noisy_replicas(z, b, 0.0025, seed)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["sample", "optimize"])
def test_matrices_and_targets(name, mode):
    dists, nonneg, circuit = CASES[name]
    ncp = mode == "sample"
    _, tau, eps, cfg, data, dn = port_side(dists, nonneg, ncp, mode)
    ref = Model(FREQ, dists, mode=mode, nonneg=nonneg, ncp=ncp)
    assert ref.D == sum(s[0] if s else 1 for s in
                        [v.shape for v in init_unconstrained(
                            cfg, data, torch.Generator().manual_seed(0))
                         .values()])
    np.testing.assert_allclose(ref.tau[0], tau, rtol=1e-15)
    assert ref.eps[0] == pytest.approx(eps, rel=1e-14)
    for i in range(len(dists)):
        np.testing.assert_allclose(ref.A[i].numpy(), data.A[i].numpy(),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(ref.L[i].numpy(), data.L[i].numpy(),
                                   rtol=1e-12, atol=1e-13)
    Z = spectra(circuit)
    zs, tg = batch._scaled_targets(Z, len(Z), None, torch.float64, "cpu",
                                   dn)
    rt, rzs = ref.targets(Z)
    np.testing.assert_allclose(rzs, zs, rtol=1e-14)
    np.testing.assert_allclose(rt.numpy(), tg.numpy(), rtol=1e-14)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["sample", "optimize"])
def test_density_and_gradient(name, mode):
    dists, nonneg, circuit = CASES[name]
    ncp = mode == "sample"
    _, _, _, cfg, data, dn = port_side(dists, nonneg, ncp, mode)
    ref = Model(FREQ, dists, mode=mode, nonneg=nonneg, ncp=ncp)
    Z = spectra(circuit)
    _, tg = batch._scaled_targets(Z, len(Z), None, torch.float64, "cpu", dn)
    gen_t = torch.Generator().manual_seed(11)
    q = ravel(cfg, init_unconstrained(cfg, data, gen_t,
                                      batch_shape=(len(Z),), jitter=1.0))
    jac = mode == "sample"
    if mode == "sample":
        lp, g = posterior_value_and_grad(cfg, data, tg, jacobian=True)(q)
    else:
        f, gf = batch.MapObjective(cfg, data, tg).value_and_grad(q)
        lp, g = -f, -gf
    rlp, rg = ref.value_and_grad(q, ref.targets(Z)[0], jacobian=jac)
    np.testing.assert_allclose(rlp.numpy(), lp.numpy(), rtol=1e-11,
                               atol=1e-8)
    np.testing.assert_allclose(rg.numpy(), g.numpy(), rtol=1e-9,
                               atol=1e-8 * float(g.abs().max()))


def test_gamma_basis_matches_summary():
    _, tau, eps, _, _, _ = port_side(ZARC, False, True, "sample")
    ref = Model(FREQ, ZARC)
    ev = np.logspace(-6, 1, 17)
    _, phi_eval = batch._phi_mats(tau, eps, ev, torch.float64, "cpu")
    np.testing.assert_allclose(ref.basis(0, ev).numpy(), phi_eval.numpy(),
                               rtol=1e-14)


def test_control_rounds_products():
    ref = Model(FREQ, ZARC, precision="tf32")
    x = torch.tensor([1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    from portbench.plainmodel import tf32_round
    assert float(tf32_round(x)[0]) == 1.0
    assert ref.dtype == torch.float32
