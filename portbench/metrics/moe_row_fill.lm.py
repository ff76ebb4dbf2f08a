"""moe_row_fill.lm: % of the E x C expert bucket rows that the dropping
dispatch computes in decode ticks that carry a kept token (the program's
``serve.moe_kept`` over ``serve.moe_rows``)."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    got = _program.counters("serve.moe_rows", "serve.moe_kept")
    if got is None:
        return None
    rows, kept = got
    return 100.0 * kept / rows
