"""moe_issue_ms.lm: the median over decode ticks of the tick's summed
``layer.moe`` spans (pre-norm, router, dispatch, experts, combine, shared
experts and residual of every MoE layer, as issued on the host), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.layer_issue_ms("layer.moe")
