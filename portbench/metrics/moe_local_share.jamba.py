"""moe_local_share.jamba: % of the decode ticks' top-k (token, slot)
assignments that land on the experts this card holds (the program's
``serve.moe_local`` over ``serve.moe_assigned``)."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    got = _program.counters("serve.moe_assigned", "serve.moe_local")
    if got is None or not got[1]:
        return None
    assigned, local = got
    return 100.0 * local / assigned
