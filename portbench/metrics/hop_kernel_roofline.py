"""hop_kernel_roofline: the hop kernel's share of its roofline, %: the
least time of one emit hop over the cell's streams on the card
(``roofline.kws_hop_bound_s``: the larger of its int8 operations over
the int8 peak and its bytes over HBM's rate) over the kernel's mean
device time a launch in the profiled window."""
from portbench import roofline


def read(ctx):
    tr, kws = ctx.get("trace"), ctx.get("kws")
    if not tr or not kws:
        return None
    count, total = 0, 0.0
    for name, (c, t) in tr["by_name"].items():
        if kws["hop_kernel"] in name:
            count, total = count + c, total + t
    if not count:
        return None
    bound, _ = roofline.kws_hop_bound_s(kws["layers"], kws["length"],
                                        kws["hop"], kws["streams"])
    return 100.0 * bound / (total / count)
