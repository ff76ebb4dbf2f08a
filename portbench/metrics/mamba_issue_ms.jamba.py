"""mamba_issue_ms.jamba: the median over decode ticks of the tick's summed
``layer.mamba`` spans (pre-norm, the Mamba step and residual of every
Mamba layer, as issued on the host), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.layer_issue_ms("layer.mamba")
