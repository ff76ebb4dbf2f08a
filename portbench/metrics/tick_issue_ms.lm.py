"""tick_issue_ms.lm: the median over decode ticks of the program's
``decode.issue`` span (the model's decode call, which returns once every
kernel is enqueued), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    return _program.tick_child_ms("decode.issue")
