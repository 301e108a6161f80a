"""The whole round's share of the card's peak: the frozen model FLOPs of
every participant's training steps (6·N·D plus attention, recomputation
not counted) of the window's rounds, over its seconds, over the
configuration's compute peak, in %."""
from bench import counts


def read(ctx):
    run = ctx["run"]
    t, arch = run.traffic, run.config["model"]
    steps = t["participants"] * t["steps_per_epoch"] * t["epochs"]
    flops = steps * counts.model_flops(arch, t["batch"], t["seq_len"],
                                       "train")
    rate = flops * ctx["calls"] / ctx["window_s"]
    return 100.0 * rate / run.config["peaks"]["flops_per_s"]
