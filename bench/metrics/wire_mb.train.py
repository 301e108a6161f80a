"""Bytes one participant puts on the wire a round (``RoundLog.comm_bytes``
of the window's last round: the encoded upload and the f32 download), in
MB."""


def read(ctx):
    n = ctx["counters"].get("comm_bytes")
    return None if n is None else n / 1e6
