"""attn_issue_ms.lm: the median over decode ticks of the tick's summed
``layer.attn`` spans (pre-norm, ``attention_decode`` and residual of
every layer, as issued on the host), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.layer_issue_ms("layer.attn")
