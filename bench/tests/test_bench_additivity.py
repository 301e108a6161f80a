"""A cell, a configuration, a traffic mix and a metric are added as new
files and ``BENCHMARK.json`` entries alone: a copy of ``bench/`` with a
throwaway cell dropped in lists it, reports its new metric and runs it,
with no file of the copy edited."""
from __future__ import annotations

import json
import shutil
import time

from bench import harness
from bench.tests import tiny

READER = '''
def read(ctx):
    return float(ctx["calls"])
'''


def test_new_cell_needs_no_edited_file(tmp_path):
    copy = tmp_path / "bench"
    shutil.copytree(tiny.BENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    spec = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())
    cfg = tiny.config(tiny.HYBRID)
    (copy / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "throwaway-decode.json").write_text(
        json.dumps(tiny.TRAFFIC["decode"]))
    (copy / "workloads" / "throwaway.decode.json").write_text(json.dumps(
        {"config": "throwaway", "traffic": "throwaway-decode", "chips": 1,
         "limits": tiny.LIMITS["decode"]}))
    (copy / "metrics" / "calls.throwaway.py").write_text(READER)
    spec["workloads"].append({"name": "throwaway.decode",
                              "config": "throwaway",
                              "traffic": "throwaway-decode", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "calls.throwaway", "unit": "calls",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["throwaway.decode"]})
    names = [m["name"] for m in harness.metrics_for(spec, "throwaway.decode",
                                                    False)]
    assert "calls.throwaway" in names and "setup_s" in names
    wl, cfg2, tr = harness.cell_files("throwaway.decode", copy)
    run = harness.Run("throwaway.decode", wl, cfg2, tr, 3, 0.0, False, "cpu",
                      time.perf_counter(), bench_dir=copy)
    res = harness.run_cell(run, spec)
    assert res["correct"] and res["metrics"]["calls.throwaway"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p
