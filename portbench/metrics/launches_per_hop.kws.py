"""launches_per_hop.kws: kernel launches the port counted
(``kernels/dispatch.py``) over the window, a hop."""


def read(ctx):
    w = ctx.get("window") or {}
    if "launches" not in w or not w.get("hops"):
        return None
    return w["launches"] / w["hops"]
