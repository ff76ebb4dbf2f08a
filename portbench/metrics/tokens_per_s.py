"""tokens_per_s: tokens generated in the window over its wall seconds."""


def read(ctx):
    w = ctx.get("window") or {}
    if "tokens" not in w:
        return None
    return w["tokens"] / w["wall_s"]
