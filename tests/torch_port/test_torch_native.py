"""The port's C++ spectrum loader (native/) against the JAX package's on
the same files: a CSV with an extra column, a Gamry .DTA file written by
sim.write_gamry_dta, bucketing by grid with a corrupt file skipped, and
the pandas fallback. Both loaders parse text with strtod, so their
values are held exactly; pandas' own float parser may differ in the last
bit, so the fallback is held to 1e-14 relative."""

import numpy as np
import pandas as pd
import pytest

from bayes_drt_tpu import native as jax_native
from bayes_drt_tpu_torch import native, sim
from bayes_drt_tpu_torch.native import _load_one_fallback


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spectra")
    rng = np.random.default_rng(0)
    grids = [np.logspace(6, -2, 65), np.logspace(5, -1, 49)]
    paths = []
    for i in range(5):
        freq = grids[i % 2]
        Z = sim.reference_circuit("ZARC", freq)
        Z = Z + 0.002 * (rng.standard_normal(len(Z))
                         + 1j * rng.standard_normal(len(Z)))
        if i < 4:
            p = d / f"spec_{i}.csv"
            pd.DataFrame({"Freq": freq, "Zreal": Z.real, "Zimag": Z.imag,
                          "Extra": np.arange(len(freq))}).to_csv(p,
                                                                  index=False)
        else:
            p = d / "spec_4.DTA"
            sim.write_gamry_dta(p, freq, Z)
        paths.append(str(p))
    bad = d / "corrupt.csv"
    bad.write_text("this is not a spectrum\x00\x01")
    return paths, str(bad)


def test_native_available():
    assert native.available(), "g++ is expected on this machine"


def test_files_match_jax_loader(files):
    paths, _ = files
    for p in paths:
        f, z = native.load_eis_file(p)
        fj, zj = jax_native.load_eis_file(p)
        np.testing.assert_array_equal(f, fj)
        np.testing.assert_array_equal(z, zj)
        # and the pandas fallback reads the same numbers
        ff, zf = _load_one_fallback(p)
        np.testing.assert_allclose(ff, f, rtol=1e-14)
        np.testing.assert_allclose(zf, z, rtol=1e-14)


def test_bucketing_matches_jax(files):
    paths, bad = files
    failed, failed_j = [], []
    got = native.load_spectra(paths + [bad], skip_errors=True, failed=failed)
    want = jax_native.load_spectra(paths + [bad], skip_errors=True,
                                   failed=failed_j)
    assert [p for p, _ in failed] == [p for p, _ in failed_j] == [bad]
    assert failed[0][1] == failed_j[0][1]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"]
        np.testing.assert_array_equal(g["freq"], w["freq"])
        np.testing.assert_array_equal(g["Z"], w["Z"])
        assert g["Z"].shape == (len(g["paths"]), len(g["freq"]))
    # largest bucket first; the Gamry file shares the 65-point grid
    assert got[0]["Z"].shape[0] == 3
    with pytest.raises(ValueError, match="native loader failed"):
        native.load_spectra([bad])
