"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and limits, and a file under ``bench/`` for every configuration,
traffic mix, cell, entry and metric it names."""
from __future__ import annotations

import json
import re

import pytest

from bench.tests import tiny

ROOT = tiny.BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    out = [c["name"] for c in SPEC["configs"]]
    out += [w[k] for w in SPEC["workloads"]
            for k in ("name", "config", "traffic")]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    out += [k for c in SPEC["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", _names())
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_and_text():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    for w in SPEC["workloads"]:
        assert TEXT.match(w["why"])
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])
    assert all(TEXT.match(w) for w in SPEC["command"])


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_name_has_its_file():
    from bench import harness
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"bench/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        wl, cfg, tr = harness.cell_files(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert (tiny.BENCH / "drivers" / f"{tr['entry']}.py").is_file()
        assert (tiny.BENCH / "reference" / f"{cfg['family']}.py").is_file()
        assert set(wl["limits"]) and all(v > 0 for v in
                                         wl["limits"].values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    from bench import harness
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        mine = {m["name"] for m in harness.metrics_for(SPEC, w["name"],
                                                       False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.metrics_for(SPEC, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_a_full_check_fits():
    n = len(SPEC["workloads"])
    assert n <= 24
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)
