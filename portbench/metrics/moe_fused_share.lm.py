"""moe_fused_share.lm: the share of decode ticks' MoE layer dispatches that
ran as the CUDA kernels of ``kernels/moe_dispatch.py`` (the program's
``serve.moe_fused`` over ``serve.moe_layer_ticks``), %.  A program that
keeps no ``serve.moe_fused`` counter gives nothing."""
from portbench.metrics import _program


def read(ctx):
    if "tokens" not in (ctx.get("window") or {}):
        return None
    for b in _program.bundles():
        reg = b.registry
        if ("serve.moe_layer_ticks" in reg
                and reg.counter("serve.moe_layer_ticks").value):
            if "serve.moe_fused" not in reg:
                return None
            return 100.0 * (reg.counter("serve.moe_fused").value
                            / reg.counter("serve.moe_layer_ticks").value)
    return None
