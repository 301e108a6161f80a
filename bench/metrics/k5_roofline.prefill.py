"""K5 (``flash_attention.cu`` ``flash_fwd_kernel``)'s share of its
roofline: the least time of one launch (causal FLOPs over the compute
peak, or q, k, v and o bytes over the memory rate, whichever is larger)
over its mean device time in the trace, in %."""
from bench import counts

KERNEL = "flash_fwd_kernel"


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if not tr:
        return None
    hits = [(t, c) for name, (t, c) in tr["by_name"].items() if KERNEL in name]
    if not hits:
        return None
    seconds = sum(t for t, _ in hits) / sum(c for _, c in hits)
    m, t = run.config["model"], run.traffic
    ops, nbytes = counts.k5(t["batch"], t["seq_len"], m["n_heads"],
                            m["n_kv_heads"], m["head_dim"])
    peaks = run.config["peaks"]
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / seconds
