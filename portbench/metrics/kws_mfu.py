"""kws_mfu: the whole hop's share of the int8 peak, %: 2 x the model's
MACs a stream-hop (``roofline.kws_hop_macs``, the emit hop: its conv
positions, ghost flush and fc cascade) x the window's stream-hops over
its wall seconds, over 1,979 TOP/s."""
from portbench import roofline


def read(ctx):
    w, kws = ctx.get("window") or {}, ctx.get("kws")
    if not kws or not w.get("stream_hops"):
        return None
    macs = roofline.kws_hop_macs(kws["layers"], kws["length"], kws["hop"])
    return 100.0 * 2 * macs * w["stream_hops"] / w["wall_s"] \
        / roofline.INT8_OPS_PER_S
