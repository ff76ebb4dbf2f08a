"""device_idle.lm: % of the profiled window in which no kernel, copy or
memset ran on the card."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "tokens" not in (ctx.get("window") or {}):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
