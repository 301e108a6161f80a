"""The whole decode step's share of the memory rate: the bytes a step
must move (every weight, the cached keys and values up to its position
and the new ones; ``counts.decode_step_bytes``) over the memory rate,
over the step's device time (as ``decode_step_ms`` reads it), in %."""
import statistics

from bench import counts


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    n = ctx["counters"].get("replays_per_call")
    if not tr or not n or not any(tr["busy_per_call_s"]):
        return None
    step_s = statistics.median(tr["busy_per_call_s"]) / n
    t = run.traffic
    nbytes = counts.decode_step_bytes(run.config["model"], t["batch"],
                                      t["prompt"], t["new"])
    return 100.0 * nbytes / run.config["peaks"]["bytes_per_s"] / step_s
