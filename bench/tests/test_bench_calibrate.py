"""``bench/calibrate.py`` reads its upper readings through the run that
``run.py`` makes and judges them by the cell's limits: at a tiny size on
the CPU, on the control test's seed, the program comes out correct and
the control and every fault not; a prefill's routing agrees with the reference's, and one flipped
pick moves the logits."""
from __future__ import annotations

import pytest

from bench import calibrate, harness
from bench.tests import test_bench_control as control, tiny


@pytest.mark.parametrize("entry,model,traffic", [
    ("round", tiny.DENSE, None),
    ("prefill", tiny.HYBRID, None),
    ("decode", control.WIDE_VOCAB, control.DECODE)],
    ids=["round", "prefill", "decode"])
def test_upper_readings_are_judged_not_correct(entry, model, traffic):
    res, r = tiny.run(entry, model, seed=control.SEED, traffic=traffic,
                      probe=calibrate.Probe(entry, control=True))
    assert res["correct"], res["checks"]
    upper = res["probe"]["upper"]
    for fault, readings in upper.items():
        ok, _ = harness.judge(readings, r.workload["limits"])
        assert not ok, (fault, readings)


def test_prefill_routing_agrees_and_one_flip_moves():
    res, _ = tiny.run("prefill", tiny.HYBRID, seed=control.SEED,
                      probe=calibrate.Probe("prefill", control=True))
    routing = res["probe"]["routing"]
    assert routing and all(c["rerun_gap"] == 0.0 for c in routing)
    layers = [m for c in routing for m in c["layers"]]
    assert len(layers) == 2 * len(routing)       # two MoE layers a call
    assert all(m["flipped"] == 0 and m["kept_differs"] == 0 for m in layers)
    assert len(res["probe"]["one_flip"]) == 2
    assert all(g > 0.0 for g in res["probe"]["one_flip"])
