"""experts_hit.lm: distinct routed experts that a decode tick's MoE layer
sends at least one token to, over every decode tick's MoE layers (the
program's ``serve.moe_experts_hit`` over ``serve.moe_layer_ticks``)."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    got = _program.counters("serve.moe_layer_ticks",
                            "serve.moe_experts_hit")
    if got is None:
        return None
    ticks, hit = got
    return hit / ticks
