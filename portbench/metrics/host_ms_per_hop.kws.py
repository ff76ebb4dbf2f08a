"""host_ms_per_hop.kws: the scheduler's own host phases of a hop (pack,
dispatch, and fold with the detector; ``StreamMetrics`` phase totals
over the window), ms a hop."""


def read(ctx):
    w = ctx.get("window") or {}
    if "host_phase_s" not in w or not w.get("hops"):
        return None
    return w["host_phase_s"] / w["hops"] * 1e3
