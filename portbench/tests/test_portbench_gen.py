"""The frozen generators and truths against the port's ``sim`` at equal
seeds."""

import numpy as np
import pytest

from bayes_drt_tpu_torch import sim
from portbench import core, gen
from portbench.tests.cpu_cells import load_config

ZARC = load_config("zarc_series")["circuit"]
SERIES_PARALLEL = load_config("sp_drt_ddt")["circuit"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_noisy_replicas_match_sim(seed):
    freq = np.logspace(6, -2, 81)
    z = gen.circuit(ZARC, freq)
    np.testing.assert_array_equal(z, sim.reference_circuit("ZARC", freq))
    np.testing.assert_array_equal(gen.noisy_replicas(z, 5, 0.0025, seed),
                                  sim.noisy_replicas(z, 5, 0.0025, seed))


def test_series_parallel_circuit_matches_sim():
    freq = np.logspace(6, -2, 81)
    np.testing.assert_allclose(gen.circuit(SERIES_PARALLEL, freq),
                               sim.series_parallel_circuit(freq),
                               rtol=1e-12, atol=0)


def test_truths_match_sim():
    tau = np.logspace(-7, 2, 91)
    np.testing.assert_allclose(
        gen.truth({"kind": "zarc", "t0": 1e-3, "phi": 0.8}, tau),
        sim.reference_gamma("ZARC", tau), rtol=1e-14)
    np.testing.assert_allclose(
        gen.truth({"kind": "cole_cole", "t0": 0.1, "phi": 0.8}, tau),
        sim.cole_cole_rbf(np.log(tau / 0.1), 0.8), rtol=1e-14)


def test_streams_are_seeded_and_distinct():
    big = 2 ** 33 + 12345
    a = [gen.stream(big, t, i) for t in range(3) for i in range(4)]
    assert a == [gen.stream(big, t, i) for t in range(3) for i in range(4)]
    assert len(set(a)) == len(a)
    assert all(0 <= s < 2 ** 31 for s in a)
    assert gen.stream(big, 2, 0) != gen.stream(big + 1, 2, 0)


def _pool(circuit=None, ref_mod=None):
    over = {"traffic": {"batch": 3, "pool": 1}}
    if circuit is not None:
        over["config"] = {"circuit": circuit}
    cell = core.load_cell("zarc-shmc", override=over)
    return core.make_pool(cell, 2 ** 33 + 9, ref_mod)


def test_the_configuration_makes_the_data():
    """A configuration's circuit parameters make its data: another t0
    gives another spectrum, and a reference module's own ``circuit``
    takes the generator's place."""
    freq, pool, z = _pool()
    moved = {"r_inf": 1.0, "elements": [dict(ZARC["elements"][0], t0=1e-2)]}
    _, pool2, z2 = _pool(moved)
    np.testing.assert_array_equal(z, gen.circuit(ZARC, freq))
    np.testing.assert_array_equal(z2, gen.circuit(moved, freq))
    assert np.abs(z2 - z).max() > 0.1
    assert np.abs(pool2[0] - pool[0]).max() > 0.1

    class Ref:
        @staticmethod
        def circuit(config, f):
            return np.full(len(f), 2.0 + 0j)

    _, pool3, z3 = _pool(ref_mod=Ref)
    np.testing.assert_array_equal(z3, np.full(len(freq), 2.0 + 0j))
    assert np.abs(pool3[0] - 2.0).max() < 0.1
