"""push_index_ms.kws: the median of the program's ``push.index``
span (a child of ``push``, ``StreamScheduler.push_audio_batch``) over
the rounds before the profiled sub-window, ms."""
from portbench.metrics import _program


def read(ctx):
    if not ctx.get("kws"):
        return None
    return _program.median_ms("push.index")
