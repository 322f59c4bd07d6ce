"""The port's cross-call cache (progcache) on the CPU: its key signature
against the JAX package's, insertion-order eviction at the cap, static
buffers that take each call's values, one entry per shape across calls,
and fits whose cache hit on other data equals a fresh build exactly."""

import numpy as np
import pytest
import torch

from bayes_drt_tpu import progcache as jax_progcache
from bayes_drt_tpu_torch import Inverter, progcache, sim
from bayes_drt_tpu_torch.infer.chees import SHMCConfig
from bayes_drt_tpu_torch.parallel import (drift_fit_spectra_batch,
                                          fit_spectra_batch,
                                          fit_spectra_ragged)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache():
    progcache.clear()
    yield
    progcache.clear()


def test_data_shapes_matches_jax():
    """The same tree of arrays and scalars gives the JAX package's
    signature; tensors sign as the numpy arrays they hold."""
    rng = np.random.default_rng(0)
    tree = {"b": (rng.standard_normal((3, 4)), 2.5, None),
            "a": [np.arange(5, dtype=np.int32), True, 7],
            "c": rng.standard_normal(2).astype(np.float32)}
    want = jax_progcache.data_shapes(tree)
    assert progcache.data_shapes(tree) == want

    def as_tensor(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x)
        return x

    t_tree = {"b": tuple(as_tensor(x) for x in tree["b"]),
              "a": [as_tensor(x) for x in tree["a"]],
              "c": as_tensor(tree["c"])}
    assert progcache.data_shapes(t_tree) == want


def test_eviction_in_insertion_order_at_the_cap(monkeypatch):
    """At the cap the oldest entry goes (released), a hit builds nothing
    and does not refresh its place, and stats count it all."""
    monkeypatch.setattr(progcache, "MAX_ENTRIES", 3)
    built, released = [], []

    class Entry:
        def __init__(self, k):
            self.k = k
            built.append(k)

        def release(self):
            released.append(self.k)

    for k in range(3):
        progcache.cached_program(("k", k), lambda k=k: Entry(k))
    assert progcache.cached_program(("k", 0), lambda: Entry(99)).k == 0
    progcache.cached_program(("k", 3), lambda: Entry(3))
    assert released == [0] and built == [0, 1, 2, 3]
    progcache.cached_program(("k", 4), lambda: Entry(4))
    assert released == [0, 1]
    assert list(progcache._CACHE) == [("k", 2), ("k", 3), ("k", 4)]
    st = progcache.stats()
    assert (st["entries"], st["hits"], st["misses"], st["evictions"]) == (
        3, 1, 5, 2)
    assert st["pool_bytes"] == 0           # no graph pools on the CPU
    progcache.clear()
    assert released == [0, 1, 2, 3, 4] and progcache.stats()["entries"] == 0


def test_bound_buffers_take_each_calls_values():
    """A Bound's function reads its buffers, so a second bind is what the
    function sees; a shape the buffers cannot take is refused."""
    a = torch.arange(6.0).reshape(2, 3)
    b = torch.ones(3)

    def make(buf):
        x, (y,) = buf
        return lambda: x @ y

    ent = progcache.bound(("t",), (a, (b,)), make)
    torch.testing.assert_close(ent.fn(), a @ b)
    ent2 = progcache.bound(("t",), (2 * a, (-b,)), make)
    assert ent2 is ent
    torch.testing.assert_close(ent.fn(), -(2 * a) @ b)
    with pytest.raises(ValueError, match="cannot take"):
        ent.bind((torch.zeros(3, 3), (b,)))


def _map_fit(freq, Zb):
    return fit_spectra_batch(freq, Zb, mode="optimize", max_iter=40,
                             polish=False, device="cpu",
                             dtype=torch.float64)


def test_same_shapes_reuse_an_entry_and_a_new_batch_makes_one():
    """As the JAX package's test_ridge_batch_program_cached_across_calls:
    other values at the same shapes add no entry, a new batch shape adds
    one."""
    f = np.logspace(4, 0, 17)
    freq, Zb = sim.make_benchmark_batch(3, freq=f, seed=1)
    _map_fit(freq, Zb)
    n1 = progcache.stats()["entries"]
    assert n1 >= 1
    freq2, Zb2 = sim.make_benchmark_batch(3, freq=f, seed=2)
    _map_fit(freq2, Zb2)
    assert progcache.stats()["entries"] == n1
    freq3, Zb3 = sim.make_benchmark_batch(16, freq=f, seed=3)
    _map_fit(freq3, Zb3)
    assert progcache.stats()["entries"] == n1 + 1


def _assert_same(a, b):
    """Two results (BatchFitResult, or dicts of arrays) exactly equal."""
    if hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f))
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            if k not in ("phase_s", "draw_s", "capture_s", "wall_time_s",
                         "ess_per_sec", "state_cfg", "dist_geometry"):
                _assert_same(a[k], b[k])
    elif isinstance(a, (np.ndarray, float, int, np.floating)):
        np.testing.assert_array_equal(a, b)


F1 = np.logspace(4, 0, 15)


def _inverter_run(kind):
    def run(z):
        inv = Inverter(device="cpu", dtype=torch.float64)
        if kind == "map":
            inv.fit(F1, z, max_iter=40, polish=False)
            return {"coef": inv.distribution_fits["DRT"]["coef"],
                    "r_inf": inv.R_inf, "lp": inv._opt_result["lp__"]}
        if kind == "map_ridge":
            inv.fit(F1, z, max_iter=40, polish=False, init_from_ridge=True)
            return {"coef": inv.distribution_fits["DRT"]["coef"],
                    "r_inf": inv.R_inf, "lp": inv._opt_result["lp__"]}
        if kind == "nuts":
            inv.fit(F1, z, mode="sample", chains=2, warmup=12, samples=6,
                    max_tree_depth=4)
        else:
            inv.fit(F1, z, mode="sample", sampler="shmc", chains=2,
                    warmup=12, samples=6,
                    shmc_cfg=SHMCConfig(n_steps=4, warm_steps=4))
        return {"draws": inv._raw_draws,
                "step": inv.sample_diagnostics["step_size"]}
    return run


def _batch_run(kind):
    def run(z):
        if kind == "batch_nuts":
            return fit_spectra_batch(F1, z, chains=2, warmup=12, samples=6,
                                     max_tree_depth=4, escalate=False,
                                     device="cpu", dtype=torch.float64)
        if kind == "batch_shmc_generic":
            return fit_spectra_batch(F1, z, chains=2, warmup=12, samples=6,
                                     outliers=True, sampler="shmc",
                                     shmc_cfg=SHMCConfig(n_steps=4,
                                                         warm_steps=4),
                                     escalate=False, device="cpu",
                                     dtype=torch.float64)
        if kind == "batch_map":
            return fit_spectra_batch(F1, z, mode="optimize", max_iter=30,
                                     device="cpu", dtype=torch.float64,
                                     polish=False)
        spectra = [(F1, zz) for zz in z]
        return fit_spectra_ragged(spectra, chains=2, warmup=12, samples=6,
                                  max_tree_depth=4, device="cpu",
                                  dtype=torch.float64)
    return run


@pytest.mark.parametrize("kind", ["map", "map_ridge", "nuts", "shmc",
                                  "batch_nuts", "batch_shmc_generic",
                                  "batch_map", "ragged_nuts"])
def test_hit_on_other_data_equals_a_fresh_build(kind):
    """Fit X (a miss), Y (a hit on other data), X again (a hit): X's two
    results are equal, and Y's hit equals a fresh build of Y after the
    cache is cleared, to the last bit."""
    _, zx = sim.make_benchmark_batch(2, freq=F1, seed=5)
    zy = 1.2 * sim.make_benchmark_batch(2, freq=F1, seed=6)[1]
    if kind in ("map", "map_ridge", "nuts", "shmc"):
        run = _inverter_run(kind)
        zx, zy = zx[0], zy[0]
    else:
        run = _batch_run(kind)
    x1 = run(zx)
    misses = progcache.stats()["misses"]
    y_hit = run(zy)
    x2 = run(zx)
    st = progcache.stats()
    assert st["misses"] == misses and st["hits"] >= 2
    _assert_same(x1, x2)
    progcache.clear()
    y_fresh = run(zy)
    _assert_same(y_hit, y_fresh)


def test_drift_fleet_hit_equals_a_fresh_build():
    """drift_fit_spectra_batch's L-BFGS runner: a hit on other cells
    equals a fresh build of them."""
    freq, times, Zc = sim.make_drift_fleet(4)
    f, t = freq[::3], times[::3]

    def run(z):
        return drift_fit_spectra_batch(f, t, z[:, ::3], n_restarts=1,
                                       max_iter=25, device="cpu",
                                       dtype=torch.float64)

    run(Zc[:2])
    hit = run(Zc[2:])
    assert progcache.stats()["hits"] >= 1
    progcache.clear()
    _assert_same(hit, run(Zc[2:]))
