"""mamba_state_ms.jamba: the median over decode ticks of the tick's summed
``mamba.state`` spans (each Mamba layer's new recurrent state written
back into the slot pool, as issued on the host), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.layer_issue_ms("mamba.state")
