"""The control, the plain reference computed on TF32-rounded operands put
in the program's place, comes out not correct at a size a test run can
hold, where the program comes out correct (``bench/calibrate.py`` reads
the same at the cells' own sizes on the card)."""
from __future__ import annotations

import copy
import time

import pytest

from bench import harness
from bench.tests import tiny

# a lower precision moves a greedy token only where the best two logits
# nearly tie: at this width it takes thousands of served tokens over a
# wide vocabulary to meet a few such ties
DECODE = {"entry": "decode", "batch": 32, "prompt": 4, "new": 120,
          "max_seq": 124, "checked_requests": 32, "traced_calls": 1}
WIDE_VOCAB = dict(tiny.DENSE, vocab_size=32768)
SEED = 2**31 + 29


def _driver(entry, model, traffic=None):
    r = harness.Run(f"tiny-{entry}", {"chips": 1, "limits":
                                      tiny.LIMITS[entry]},
                    tiny.config(model),
                    copy.deepcopy(traffic or tiny.TRAFFIC[entry]),
                    SEED, 0.0, False, "cpu", time.perf_counter())
    drv = harness.driver_module(r.traffic).Driver(r)
    drv.setup()
    calls, _, _ = harness.window(drv.call, 0.0, r.device)
    drv.window_calls = calls
    drv.release()
    return drv


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.HYBRID],
                         ids=lambda m: m["name"])
def test_round_control_fails(model):
    drv = _driver("round", model)
    ref = drv.reference_rounds()
    control = drv.compare(*drv.reference_rounds(low=True)[:2], *ref)
    program = drv.compare(drv.prog_losses, drv.prog_norms, *ref)
    ok, _ = harness.judge(program, tiny.LIMITS["round"])
    bad, _ = harness.judge(control, tiny.LIMITS["round"])
    assert ok and not bad, (program, control)


def test_prefill_control_fails():
    from bench.drivers.prefill import logit_gap
    drv = _driver("prefill", tiny.HYBRID)
    i = drv.sample()[0]
    ref = drv.reference_logits(i)
    gap = logit_gap(drv.reference_logits(i, low=True), ref)
    assert logit_gap(drv.answers[i], ref) <= tiny.LIMITS["prefill"][
        "logit_gap"] < gap


def test_decode_control_fails():
    drv = _driver("decode", WIDE_VOCAB, DECODE)
    picks = drv.sample()
    served = float(drv.reference_gaps(picks).max())
    control = float(drv.reference_gaps(picks, low=True).max())
    assert served <= tiny.LIMITS["decode"]["served_gap"] < control
