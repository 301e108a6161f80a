"""``run.py``'s refusals: without the cards a cell asks for it exits
non-zero and prints no result, and so it does in a directory that holds
only ``BENCHMARK.json`` and ``bench/`` (the program is missing). The
card's own run of a tiny cell is marked ``gpu`` and decides in its
fixture."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench.tests import tiny

ROOT = tiny.BENCH.parent
ARGS = ["--workload", "internlm2-decode-b32", "--seed", "3", "--seconds",
        "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("entry,model", [("round", tiny.DENSE),
                                         ("prefill", tiny.HYBRID),
                                         ("decode", tiny.DENSE)])
def test_tiny_cells_on_the_card(card, entry, model):
    import time
    from bench import harness
    wl = {"config": model["name"], "traffic": entry, "chips": 1,
          "limits": tiny.LIMITS[entry]}
    run = harness.Run(f"tiny-{entry}", wl, tiny.config(model),
                      dict(tiny.TRAFFIC[entry]), 5, 0.5, True, card,
                      time.perf_counter())
    res = harness.run_cell(run, {"end_to_end": [], "per_layer": []})
    assert res["correct"], json.dumps(res["checks"])
    assert res["device"]["busy_s"] > 0
