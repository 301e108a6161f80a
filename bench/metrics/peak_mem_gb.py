"""The card's memory the window needed: the allocator's reserved peak
over the window (reset at its start, after set-up's cached temporaries
were given back), in GB. Reserved, not allocated: a captured graph's
pool is reserved once and reused by every replay."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
