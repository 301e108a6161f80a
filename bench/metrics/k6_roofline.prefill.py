"""K6 (``selective_scan.cu`` ``selective_scan_kernel``)'s share of its
roofline: the least time of one launch (its bytes from B, S, d_inner and
d_state over the memory rate, or its operations over the compute peak,
whichever is larger) over its mean device time in the trace, in %."""
from bench import counts

KERNEL = "selective_scan_kernel"


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if not tr:
        return None
    hits = [(t, c) for name, (t, c) in tr["by_name"].items() if KERNEL in name]
    if not hits:
        return None
    seconds = sum(t for t, _ in hits) / sum(c for _, c in hits)
    m, t = run.config["model"], run.traffic
    ops, nbytes = counts.k6(t["batch"], t["seq_len"],
                            m["ssm_expand"] * m["d_model"], m["ssm_state_dim"])
    peaks = run.config["peaks"]
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / seconds
