"""tick_fence_ms.lm: the median over decode ticks of the program's
``decode.fence`` span (the tokens' host copy: the wait on the card), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.tick_child_ms("decode.fence")
