"""join_ms.kws: the median of the program's ``join`` span
(``StreamScheduler.add_stream``) over set-up's joins, ms."""
from portbench.metrics import _program


def read(ctx):
    if not ctx.get("kws"):
        return None
    return _program.median_ms("join")
