"""push_ms.kws: ms a round in ``StreamScheduler.push_audio_batch`` (the
benchmark's clock around the call), over the window's rounds."""


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("push_s"):
        return None
    return sum(w["push_s"]) / len(w["push_s"]) * 1e3
