"""prefill_ms.lm: the median of the program's ``serve.prefill_s``
histogram (one prompt's prefill, its first token sampled), ms."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    got = _program.histogram_median("serve.prefill_s")
    return None if got is None else got * 1e3
