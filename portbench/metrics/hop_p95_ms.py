"""hop_p95_ms: the 95th percentile, over every stream-hop of the window,
of the time from the start of its round's push (its audio is due) until
its posteriors are on the host.  A closed-loop round serves every stream
at once, so each stream-hop of a round shares the round's time."""
import numpy as np


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("hop_latency_s"):
        return None
    return float(np.percentile(w["hop_latency_s"], 95)) * 1e3
