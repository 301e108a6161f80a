"""Seconds from the process's start to the window's: imports, the
weights, the program's build and capture, the warm-up, the first steps."""


def read(ctx):
    return ctx["setup_s"]
