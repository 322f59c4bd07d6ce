"""Instrument file loading: Gamry .DTA and ZPlot .z parsers plus DataFrame
helpers (copy of bayes_drt_tpu/io/file_load.py, which this package may not
import; reference: bayes_drt/file_load.py).

Pure host-side text parsing. pandas is imported inside the functions that
build DataFrames, so the package imports without it.
"""

from __future__ import annotations

import os
import warnings
from datetime import datetime, timedelta

import numpy as np

from ..utils import polar_from_complex


def _read_text(file) -> str:
    try:
        with open(file, "r") as f:
            return f.read()
    except UnicodeDecodeError:
        with open(file, "r", encoding="latin1") as f:
            return f.read()


def source_extension(source: str) -> str:
    return {"gamry": ".DTA", "zplot": ".z"}[source]


def get_file_source(file) -> str:
    """'gamry' (EXPLAIN header) or 'zplot' (ZPLOT2 ASCII header)
    (reference: file_load.py:23-37)."""
    first = _read_text(file).split("\n", 1)[0].strip("\r")
    if first == "EXPLAIN":
        return "gamry"
    if first == "ZPLOT2 ASCII":
        return "zplot"
    raise ValueError(f"Unrecognized file format for {file}")


def get_timestamp(file) -> datetime:
    """Experiment start timestamp (reference: file_load.py:40-79)."""
    txt = _read_text(file)
    source = get_file_source(file)

    def field(tag, split_idx, sep=None):
        start = txt.find(tag)
        line = txt[start:start + txt[start:].find("\n")]
        parts = line.split(sep) if sep else line.split()
        return parts[split_idx]

    if source == "gamry":
        date = field("DATE", 2, "\t")
        time = field("TIME", 2, "\t")
        return datetime.strptime(f"{date} {time}", "%m/%d/%Y %H:%M:%S")
    date = field("Date", 1)
    time = field("Time", 1)
    return datetime.strptime(f"{date} {time}", "%m-%d-%Y %H:%M:%S")


def _read_gamry_table(file, txt, marker, skipfooter=0):
    """Extract a tab-separated Gamry data table following ``marker``."""
    import pandas as pd

    cidx = txt.find(marker)
    if cidx == -1:
        return None
    pretxt = txt[:cidx]
    table = txt[cidx:]
    header_start = table.find("\n") + 1
    header_end = header_start + table[header_start:].find("\n")
    header = table[header_start:header_end].strip("\r").split("\t")
    skiprows = len(pretxt.split("\n")) + 2
    usecols = header[1:] if header[0] == "" else header
    # extra trailing tab (Igor exports) needs a dummy column
    unit_end = header_end + 1 + table[header_end + 1:].find("\n")
    first_row = table[unit_end + 1: unit_end + 1 + table[unit_end + 1:].find("\n")]
    if first_row.split("\t")[-1].strip("\r") == "":
        header = header + ["extra_tab"]
    return pd.read_csv(file, sep="\t", skiprows=skiprows, header=None,
                       names=header, usecols=usecols, skipfooter=skipfooter,
                       engine="python", encoding="latin1")


def _add_timestamp(data, file, warn=True):
    try:
        dt = get_timestamp(file)
        time_col = [c for c in ("Time", "T") if c in data.columns][0]
        data["timestamp"] = [dt + timedelta(seconds=t) for t in data[time_col]]
    except Exception:
        if warn:
            warnings.warn(f"Reading timestamp failed for file {file}")
    return data


def read_eis(file, warn=True):
    """EIS spectrum from a Gamry .DTA or ZPlot .z file
    (reference: file_load.py:82-175). Columns: Freq, Zreal, Zimag, Zmod,
    Zphz [, timestamp]."""
    import pandas as pd

    txt = _read_text(file)
    source = get_file_source(file)
    if source == "gamry":
        if txt.find("EXPERIMENTABORTED") > -1:
            skipfooter = len(txt[txt.find("EXPERIMENTABORTED"):].split("\n")) - 1
        else:
            skipfooter = 0
        data = _read_gamry_table(file, txt, "ZCURVE", skipfooter=skipfooter)
        data = _add_timestamp(data, file, warn=warn)
        return data

    # zplot: headers on the line above "End Comments"
    zidx = txt.find("End Comments")
    pretxt = txt[:zidx]
    header = pretxt.split("\n")[-2].strip().split("\t")
    skiprows = len(pretxt.split("\n"))
    usecols = header[1:] if header[0] == "" else header
    data = pd.read_csv(file, sep="\t", skiprows=skiprows, header=None,
                       names=header, usecols=usecols, encoding="latin1")
    data = data.rename({"Z'(a)": "Zreal", "Z''(b)": "Zimag",
                        "Freq(Hz)": "Freq"}, axis=1)
    zmod, zphz = polar_from_complex(data["Zreal"].values
                                    + 1j * data["Zimag"].values)
    data["Zmod"] = zmod
    data["Zphz"] = zphz
    return data


def read_jv(file, source="gamry"):
    """j-V curve (reference: file_load.py:178-222)."""
    import pandas as pd

    txt = _read_text(file)
    if source == "manual":
        jv_idx = txt.find("Current")
        skiprows = len(txt[:jv_idx].split("\n")) - 1
        return pd.read_csv(file, sep="\t", skiprows=skiprows, encoding="latin1")
    if source == "gamry":
        return _read_gamry_table(file, txt, "CURVE\tTABLE")
    raise ValueError(f"Invalid source {source}. Options are 'gamry', 'manual'")


def read_ocv(file, file_type="auto"):
    """OCV data from Gamry .DTA (reference: file_load.py:225-286)."""
    import pandas as pd

    txt = _read_text(file)
    if file_type == "auto":
        file_type = os.path.basename(file).split("_")[0].lower()[:3]
    if file_type in ("ocv", "ocp"):
        marker, skipfooter = "CURVE\tTABLE", 0
    elif file_type == "eis":
        marker = "OCVCURVE\tTABLE"
        post = txt[txt.find("EOC\tQUANT"):]
        skipfooter = len(post.split("\n")) - 1
    else:
        raise ValueError(f"Invalid file_type {file_type}")
    data = _read_gamry_table(file, txt, marker, skipfooter=skipfooter)
    if data is None:
        return pd.DataFrame([])
    return _add_timestamp(data, file)


def read_gen_curve(file):
    """Generic Gamry CURVE table (reference: file_load.py:289-341)."""
    import pandas as pd

    txt = _read_text(file)
    data = _read_gamry_table(file, txt, "CURVE\tTABLE")
    if data is None:
        return pd.DataFrame([])
    return _add_timestamp(data, file)


def read_lsv(file):
    """LSV data from Gamry .DTA (reference: file_load.py:344-378)."""
    txt = _read_text(file)
    return _read_gamry_table(file, txt, "CURVE\tTABLE")


def get_fZ(df):
    """(frequencies, complex Z) from a standard EIS DataFrame
    (reference: file_load.py:384-389)."""
    return df["Freq"].values, df["Zreal"].values + 1j * df["Zimag"].values


def construct_eis_df(f, Z):
    """Standard EIS DataFrame from arrays (reference: file_load.py:392-405)."""
    import pandas as pd

    df = pd.DataFrame(np.asarray(f, float), columns=["Freq"])
    Z = np.asarray(Z)
    df["Zreal"] = Z.real
    df["Zimag"] = Z.imag
    df["Zmod"] = np.abs(Z)
    df["Zphz"] = np.degrees(np.arctan(Z.imag / Z.real))
    return df


def load_eis_dir(directory, pattern="*.DTA"):
    """Batch-load every EIS file in a directory (sorted) — convenience for
    feeding fit_spectra_batch."""
    import glob
    files = sorted(glob.glob(os.path.join(directory, pattern)))
    return files, [read_eis(f, warn=False) for f in files]
