"""The device time of one replayed decode step: the median over the
traced calls of the device's busy time in a call over the call's replays
(every prompt and decode token replays the one captured step), in ms."""
import statistics


def read(ctx):
    tr = ctx["trace"]
    n = ctx["counters"].get("replays_per_call")
    if not tr or not n or not any(tr["busy_per_call_s"]):
        return None
    return 1e3 * statistics.median(tr["busy_per_call_s"]) / n
