"""Tokens the window's calls completed over the window's seconds (whole
calls: the window closes at the end of the first call ending after
``--seconds``)."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
