"""push_block_share.kws: % of the arena rows that the program's pushes
landed by ``RingArena.push_batch``'s block path (the program's
``stream.push_block_rows`` over ``stream.push_rows``), set-up and the
window."""
from portbench.metrics import _program


def read(ctx):
    if not ctx.get("kws"):
        return None
    got = _program.counters("stream.push_rows", "stream.push_block_rows")
    if got is None:
        return None
    rows, block = got
    return 100.0 * block / rows
