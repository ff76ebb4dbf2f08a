"""lm_mfu: the whole tick's share of the bf16 peak, %: the model's FLOPs
for the window's tokens (``roofline.lm_token_flops``: the parameters each
token uses under top-k and the shared experts, and attention over the
positions it attends) over the window's wall seconds, over 989 TFLOP/s."""
from portbench import roofline


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("contexts"):
        return None
    flops = sum(w["rows"] * roofline.lm_token_flops(ctx["config"], c)
                for c in w["contexts"])
    return 100.0 * flops / w["wall_s"] / roofline.BF16_FLOPS_PER_S
