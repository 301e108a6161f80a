"""The device's idle share of the traced sub-window: 1 - the union of
every device operation's interval over the window's length, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
