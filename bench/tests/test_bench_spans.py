"""Program spans (``repro_torch.spans``) are mirrored on the device's
timeline under a profiler. ``traced_window`` may turn them on only where
``reduce_trace`` leaves those ``rt.*`` mirrors out of the device's busy
time: a mirror that spans an idle gap would read as work and move
``device_idle.*`` and ``decode_step_ms``."""
import torch

from bench import harness
from repro_torch import spans


def _trace(mirrored):
    """One call with two kernels and an idle gap between them; with
    ``mirrored``, a program span's device mirror across the gap."""
    events = [("bench.call", False, 0, 100), ("kernel_a", True, 10, 20),
              ("kernel_b", True, 60, 70)]
    if mirrored:
        events.append(("rt.prefill", True, 10, 70))
    return events


def test_spans_in_the_traced_window_only_with_their_mirrors_left_out():
    bare, mirrored = (harness.reduce_trace(_trace(m)) for m in (False, True))
    left_out = all(bare[k] == mirrored[k]
                   for k in ("busy_s", "busy_per_call_s", "idle_gaps"))
    seen = []
    harness.traced_window(lambda i: seen.append(spans.enabled()), 2,
                          torch.device("cpu"), 0)
    assert len(seen) == 2 and not spans.enabled()
    assert left_out or not any(seen), (
        "traced_window turns the program's spans on, but reduce_trace "
        "counts their rt.* device mirrors as busy time")
