"""tick_ms_p95.lm: the 95th percentile of ``Engine.step`` over the
window's decode ticks (the benchmark's clock around each step, which
ends when its tokens are on the host), ms."""
import numpy as np


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("tick_s"):
        return None
    return float(np.percentile(w["tick_s"], 95)) * 1e3
