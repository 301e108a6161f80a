"""The whole prefill's share of the card's peak: the frozen model FLOPs
of the window's prefills (2·N_active·D plus attention), over its seconds,
over the configuration's compute peak, in %."""
from bench import counts


def read(ctx):
    run = ctx["run"]
    t, arch = run.traffic, run.config["model"]
    flops = counts.model_flops(arch, t["batch"], t["seq_len"], "prefill")
    rate = flops * ctx["calls"] / ctx["window_s"]
    return 100.0 * rate / run.config["peaks"]["flops_per_s"]
