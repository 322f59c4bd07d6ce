"""The port's copy of io/file_load.py against the JAX package's on the
same files: read_eis and get_fZ on a Gamry .DTA (and a ZPlot .z) file,
get_timestamp, construct_eis_df, load_eis_dir and the Gamry curve
readers. Both parse with pandas, so the frames are held equal."""

import numpy as np
import pandas as pd
import pytest

from bayes_drt_tpu import io as jax_io
from bayes_drt_tpu_torch import io, sim

FREQ = np.logspace(5, -1, 31)
Z = sim.reference_circuit("ZARC", FREQ)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eis")
    sim.write_gamry_dta(d / "EIS_a.DTA", FREQ, Z)
    sim.write_gamry_dta(d / "EIS_b.DTA", FREQ[::2], Z[::2] * 2,
                        start="12/01/2022 08:05:09")
    # a ZPlot export: comments, the column header above "End Comments"
    zp = ["ZPLOT2 ASCII", "Date: 01-02-2021", "Time: 10:11:12",
          "Freq(Hz)\tZ'(a)\tZ''(b)", "End Comments"]
    zp += [f"{float(f)!r}\t{float(z.real)!r}\t{float(z.imag)!r}"
           for f, z in zip(FREQ, Z)]
    (d / "spec.z").write_text("\n".join(zp) + "\n")
    # a Gamry OCV curve
    lines = ["EXPLAIN", "TAG\tCORPOT", "DATE\tLABEL\t03/15/2021\tDate",
             "TIME\tLABEL\t14:30:00\tTime", "CURVE\tTABLE",
             "\tPt\tT\tVf\tVm\tAch", "\t#\ts\tV vs. Ref.\tV\tV"]
    lines += [f"\t{i}\t{float(i)!r}\t{0.9 + 0.001 * i!r}\t0.0\t0.0"
              for i in range(12)]
    (d / "OCV_a.DTA").write_text("\n".join(lines) + "\n")
    return d


def _frames_equal(a, b):
    assert list(a.columns) == list(b.columns)
    pd.testing.assert_frame_equal(a, b)


def test_read_eis_and_get_fz_match_jax(data_dir):
    for name in ("EIS_a.DTA", "EIS_b.DTA", "spec.z"):
        p = str(data_dir / name)
        df, dj = io.read_eis(p, warn=False), jax_io.read_eis(p, warn=False)
        _frames_equal(df, dj)
        f, z = io.get_fZ(df)
        fj, zj = jax_io.get_fZ(dj)
        np.testing.assert_array_equal(f, fj)
        np.testing.assert_array_equal(z, zj)
    f, z = io.get_fZ(io.read_eis(str(data_dir / "EIS_a.DTA")))
    np.testing.assert_allclose(z, Z, rtol=1e-15)
    for name in ("EIS_b.DTA", "spec.z"):
        p = str(data_dir / name)
        assert io.get_timestamp(p) == jax_io.get_timestamp(p)
        assert io.get_file_source(p) == jax_io.get_file_source(p)


def test_frames_and_curves_match_jax(data_dir):
    _frames_equal(io.construct_eis_df(FREQ, Z),
                  jax_io.construct_eis_df(FREQ, Z))
    files, dfs = io.load_eis_dir(str(data_dir), "EIS_*.DTA")
    files_j, dfs_j = jax_io.load_eis_dir(str(data_dir), "EIS_*.DTA")
    assert files == files_j and len(files) == 2
    for a, b in zip(dfs, dfs_j):
        _frames_equal(a, b)
    p = str(data_dir / "OCV_a.DTA")
    for fn in ("read_ocv", "read_gen_curve", "read_lsv", "read_jv"):
        _frames_equal(getattr(io, fn)(p), getattr(jax_io, fn)(p))
    assert io.source_extension("zplot") == ".z"
