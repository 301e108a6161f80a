"""K3 (``wire.cu`` ``quant_avg_dequant_kernel``)'s share of its roofline:
the least time of one launch (the larger of its bytes over the memory
rate and its operations over the compute peak, from the (K, N_pad) f32
shape) over its mean device time in the trace, in %."""
from bench import counts

KERNEL = "quant_avg_dequant_kernel"


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if not tr:
        return None
    hits = [(t, c) for name, (t, c) in tr["by_name"].items() if KERNEL in name]
    if not hits:
        return None
    seconds = sum(t for t, _ in hits) / sum(c for _, c in hits)
    ops, nbytes = counts.k3(run.config["model"], run.traffic["participants"])
    peaks = run.config["peaks"]
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / seconds
