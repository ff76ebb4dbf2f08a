"""kernels_per_tick.lm: CUDA kernels in the profiled window a tick."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "tokens" not in (ctx.get("window") or {}):
        return None
    return tr["kernel_count"] / tr["steps"]
