"""device_idle.kws: % of the profiled window in which no kernel, copy or
memset ran on the card."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("kws"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
