"""BENCHMARK.json against the contract it is written to: its keys, the
characters of every name and unit, its files, and which cell reports
which metric."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not re.search(
        r"[\n\r\t]", s)


def test_top_level():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(text_ok(w) for w in BENCH["command"])
    for w in BENCH["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def all_names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden|width|size)$", k)
        assert (ROOT / "portbench/reference" / f"{c['name']}.py").is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(set(names)) == len(names)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()


def reports(w, metric):
    return w in metric.get("workloads", [w])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports(w):
    e2e = [m for m in BENCH["end_to_end"] if reports(w, m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if reports(w, m)
             and ("workloads" in m or m["moves"] in {x["name"] for x in e2e})]
    assert layer
    for m in BENCH["per_layer"]:
        if w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in e2e}
