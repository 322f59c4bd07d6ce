"""The port's device mesh (parallel/mesh.py) against the JAX package's
(bayes_drt_tpu/parallel/mesh.py) on the CPU, the port's virtual CPU
shards against the JAX package's virtual 8-device CPU mesh
(tests/conftest.py): the mesh's shape and errors, a shard's exception,
the ridge and its CV on 8 shards with the layout assertions of
tests/test_round3.py:395-420 and the unsharded fits' bars, a one-shard
mesh bit for bit, the cache's per-shard keys, the flat-chain arm's
refusal and the CLI's --mesh. The other entry points' fits on a mesh
are in test_torch_mesh_fits.py, the sampled main path in
test_torch_mesh_sampled.py."""

import numpy as np
import pandas as pd
import pytest
import torch

from bayes_drt_tpu.cli import main as jax_main
from bayes_drt_tpu.parallel import fit_spectra_batch as jax_fit
from bayes_drt_tpu.parallel import make_mesh as jax_make_mesh
from bayes_drt_tpu.parallel import ridge_fit_spectra_batch as jax_ridge
from bayes_drt_tpu.infer.chees import SHMCConfig as JaxSHMCConfig
from bayes_drt_tpu_torch import progcache, sim
from bayes_drt_tpu_torch.cli import main as port_main
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.parallel import (fit_spectra_batch, make_mesh,
                                          ridge_fit_spectra_batch)
from bayes_drt_tpu_torch.parallel.mesh import run_shards

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
EIGHT = tuple((i, i, i + 1) for i in range(8))


def _batch(b=8, n=41, noise=0.002, seed=0):
    return sim.make_benchmark_batch(b, freq=np.logspace(6, -2, n),
                                    noise_level=noise, seed=seed)


def _cpu_mesh(n, chains_axis=1):
    return make_mesh(n, chains_axis=chains_axis, device="cpu")


def test_make_mesh_matches_jax():
    """Axis names, shapes and the divisibility error of the JAX package's
    make_mesh; replicas along 'chains' listed with their row's range."""
    for n, c in ((8, 1), (8, 2), (4, 4)):
        got, want = _cpu_mesh(n, c), jax_make_mesh(n, c)
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
        assert got.size == want.size
    with pytest.raises(ValueError, match="not divisible by chains_axis"):
        _cpu_mesh(6, 4)
    with pytest.raises(ValueError, match="not divisible by chains_axis"):
        jax_make_mesh(6, 4)
    assert _cpu_mesh(4, 2).layout(8) == ((0, 0, 4), (1, 0, 4), (2, 4, 8),
                                          (3, 4, 8))
    assert _cpu_mesh(3).ranges(8) == [(0, 3), (3, 6), (6, 8)]


def test_make_mesh_cuda_needs_the_card():
    """On CUDA a mesh takes the visible cards, never more than exist."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_mesh().size == n
        with pytest.raises(ValueError, match="only"):
            make_mesh(n + 1)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_shard_exception_propagates():
    """A shard's exception reaches the caller once every shard is done."""
    mesh = _cpu_mesh(4)
    done = []

    def fn(sh):
        done.append(sh.position)
        if sh.position == 2:
            raise RuntimeError("shard 2 failed")
        return sh.start

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        run_shards(fn, mesh.shards(8))
    assert sorted(done) == [0, 1, 2, 3]
    assert run_shards(lambda sh: sh.stop, mesh.shards(8)) == [2, 4, 6, 8]


def test_ridge_partitions_and_matches_unsharded():
    """tests/test_round3.py:395-420: the ridge and its Re-Im CV on 8
    shards, one spectrum a device in both packages, equal to the
    unsharded fits at the JAX tests' bars (the CV's selected lambda
    exactly)."""
    freq, Zb = _batch(8)
    lams = np.logspace(-4, 0, 3)
    for kw in ({}, dict(hyper_lambda=False, penalty="discrete",
                        cv_lambdas=lams)):
        got = ridge_fit_spectra_batch(freq, Zb, mesh=_cpu_mesh(8), **F64,
                                      **kw)
        want = jax_ridge(freq, Zb, mesh=jax_make_mesh(8), **kw)
        assert got.diagnostics["shard_layout"] == EIGHT
        assert want.diagnostics["shard_layout"] == EIGHT
        res_u = ridge_fit_spectra_batch(freq, Zb, **F64, **kw)
        np.testing.assert_allclose(got.coef, res_u.coef, rtol=1e-5,
                                   atol=1e-7)
        if "cv_lambdas" in kw:
            np.testing.assert_array_equal(got.diagnostics["cv_lambda"],
                                          res_u.diagnostics["cv_lambda"])
            np.testing.assert_array_equal(got.diagnostics["cv_lambda"],
                                          want.diagnostics["cv_lambda"])


def _main_path_kw():
    return dict(chains=4, warmup=60, samples=60, ncp=True, sampler="shmc",
                shmc_cfg=SHMCConfig(n_steps=8, warm_steps=8,
                                    eps_quantile=0.5), escalate=False,
                random_seed=1)


def test_one_shard_mesh_is_bitwise():
    """A one-device mesh is the meshless fit bit for bit: the main path,
    a generic SHMC fit, MAP, a NUTS fit resumed with warm_start and the
    pooled preconditioner; on two shards the last two run too."""
    freq, Zb = _batch(4, n=21)
    fits = {
        "main": dict(_main_path_kw(), warmup=20, samples=10),
        "generic": dict(_main_path_kw(), warmup=20, samples=10,
                        outliers=True),
        "map": dict(mode="optimize", max_iter=100),
        "pooled": dict(chains=2, warmup=40, samples=10, ncp=True,
                       max_tree_depth=4, precondition="pooled",
                       pilot_warmup=10, pilot_samples=10, escalate=False)}
    for name, kw in fits.items():
        one = fit_spectra_batch(freq, Zb, mesh=_cpu_mesh(1), **F64, **kw)
        ref = fit_spectra_batch(freq, Zb, **F64, **kw)
        assert np.array_equal(one.coef, ref.coef), name
        assert one.diagnostics["shard_layout"] == ((0, 0, 8),), name
        if name == "pooled":
            two = fit_spectra_batch(freq, Zb, mesh=_cpu_mesh(2), **F64, **kw)
            d = two.diagnostics["state_q"].shape[-1]
            assert two.diagnostics["state_inv_mass"].shape == (4, 2, d, d)
            assert np.isfinite(two.coef).all()
    wkw = dict(chains=2, warmup=10, samples=10, ncp=True, max_tree_depth=4,
               escalate=False)
    cold = fit_spectra_batch(freq, Zb, **F64, **wkw)
    for n in (1, 2):
        warm = fit_spectra_batch(freq, 1.03 * Zb, mesh=_cpu_mesh(n),
                                 warm_start=cold, **F64, **wkw)
        if n == 1:
            ref = fit_spectra_batch(freq, 1.03 * Zb, warm_start=cold, **F64,
                                    **wkw)
            assert np.array_equal(warm.coef, ref.coef)
        assert np.isfinite(warm.coef).all()


def test_virtual_shards_key_the_cache_apart():
    """Virtual shards share the CPU device, so each keys its runners under
    its own scope: an 8-shard fit leaves entries of 8 scopes."""
    progcache.clear()
    freq, Zb = _batch(8, n=21)
    fit_spectra_batch(freq, Zb, mode="optimize", max_iter=20, polish=False,
                      mesh=_cpu_mesh(8), **F64)
    scopes = {k[-1] for k in progcache._CACHE}
    assert scopes == {("scope", i) for i in range(8)}
    progcache.clear()


def test_cache_under_concurrent_shards():
    """The cache shared by shard threads: 16 threads (more than the
    cores), each under its own scope, look up the same 4 keys 50 times
    with a short switch interval; every lookup is counted once and each
    scope builds each key once."""
    import sys
    import threading
    progcache.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(tag):
            with progcache.scope(tag):
                for i in range(50):
                    progcache.cached_program(("k", i % 4), lambda: object())

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    st = progcache.stats()
    assert st["misses"] == 16 * 4 and st["entries"] == 16 * 4
    assert st["hits"] == 16 * 50 - 16 * 4
    progcache.clear()


def test_flat_chain_with_mesh_raises():
    """Naming the flat-chain arm with a mesh raises the JAX package's
    ValueError in both packages (bayes_drt_tpu/parallel/batch.py:649-652);
    the port's default K1 route shards."""
    freq, Zb = _batch(8, n=21)
    for flag in ("pallas_traj", "flat_chain"):
        with pytest.raises(ValueError,
                           match="does not shard over a mesh"):
            fit_spectra_batch(freq, Zb, sampler="shmc",
                              shmc_cfg=SHMCConfig(**{flag: True}),
                              mesh=_cpu_mesh(2), device="cpu")
        with pytest.raises(ValueError,
                           match="does not shard over a mesh"):
            jax_fit(freq, Zb, sampler="shmc",
                    shmc_cfg=JaxSHMCConfig(**{flag: True}),
                    mesh=jax_make_mesh(2))


def test_precision_high_on_a_multi_card_mesh_raises():
    """precision='high' (tf32x3, whose TF32 switch is process-wide) is
    refused on a mesh whose shards run on two CUDA devices, in the batch
    and the ragged entry points, before anything runs; a mesh of CPU
    shards and a one-card mesh (its replica along 'chains' included)
    pass the check."""
    from bayes_drt_tpu_torch.parallel import fit_spectra_ragged
    from bayes_drt_tpu_torch.parallel.mesh import DeviceMesh, check_precision

    def cuda_mesh(n, chains_axis=1):
        arr = np.empty(n, dtype=object)
        arr[:] = [torch.device("cuda", i) for i in range(n)]
        return DeviceMesh(arr.reshape(n // chains_axis, chains_axis),
                          np.arange(n).reshape(n // chains_axis,
                                               chains_axis))

    high = SHMCConfig(precision="high")
    freq, Zb = _batch(4, n=21)
    with pytest.raises(ValueError, match="more than one CUDA device"):
        fit_spectra_batch(freq, Zb, sampler="shmc", shmc_cfg=high,
                          mesh=cuda_mesh(2))
    with pytest.raises(ValueError, match="more than one CUDA device"):
        fit_spectra_ragged([(freq, z) for z in Zb], sampler="shmc",
                           shmc_cfg=high, mesh=cuda_mesh(2))
    for mesh in (cuda_mesh(1), cuda_mesh(2, chains_axis=2), _cpu_mesh(4),
                 None):
        check_precision(mesh, "high")
    check_precision(cuda_mesh(2), "highest")


def test_cli_mesh_sample_mode(tmp_path):
    """The CLI's --mesh on a small directory in sample mode: the port's
    one CPU shard writes what its meshless command writes, bit for bit,
    and the same files and columns as the JAX CLI on its 8 devices."""
    data = tmp_path / "spectra"
    data.mkdir()
    freq, Zb = _batch(3, n=41, seed=4)
    for i, z in enumerate(Zb):
        pd.DataFrame({"Freq": freq, "Zreal": z.real, "Zimag": z.imag}
                     ).to_csv(data / f"spec_{i}.csv", index=False)
    base = ["fit", str(data), "--pattern", "*.csv", "--chains", "2",
            "--warmup", "20", "--samples", "10", "--no-escalate"]
    outs = {}
    for name, run, extra in (
            ("mesh", port_main, ["--mesh", "--device", "cpu"]),
            ("meshless", port_main, ["--device", "cpu"]),
            ("jax", jax_main, ["--mesh"])):
        outs[name] = tmp_path / name
        assert run(base + ["--out", str(outs[name])] + extra) == 0
    names = sorted(p.name for p in outs["mesh"].iterdir())
    assert names == sorted(p.name for p in outs["jax"].iterdir())
    for nm in names:
        got = pd.read_csv(outs["mesh"] / nm)
        if nm.startswith("Gout"):
            assert got.equals(pd.read_csv(outs["meshless"] / nm)), nm
        assert list(got.columns) == list(pd.read_csv(outs["jax"] / nm)
                                         .columns), nm
