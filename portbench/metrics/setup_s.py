"""setup_s: seconds from process start until the window opens (imports,
weights and inputs from the seed, the program built and warmed)."""


def read(ctx):
    return ctx.get("setup_s")
