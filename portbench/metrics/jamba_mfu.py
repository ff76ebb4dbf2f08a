"""jamba_mfu: the whole tick's share of the bf16 peak, %: the FLOPs this
card's share does for the window's ticks (``roofline_hybrid.tick_flops``:
the mixers, dense FFNs, routers and head of every row, attention over
the positions attended, the held experts at the (token, slot) pairs they
keep, the program's ``serve.moe_kept`` over ``serve.moe_layer_ticks``)
over the window's wall seconds, over 989 TFLOP/s."""
from portbench import roofline, roofline_hybrid
from portbench.metrics import _program


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("contexts"):
        return None
    got = _program.counters("serve.moe_layer_ticks", "serve.moe_kept")
    if got is None:
        return None
    layer_ticks, kept = got
    flops = sum(roofline_hybrid.tick_flops(ctx["config"], w["rows"], c,
                                           kept / layer_ticks)
                for c in w["contexts"])
    return 100.0 * flops / w["wall_s"] / roofline.BF16_FLOPS_PER_S
