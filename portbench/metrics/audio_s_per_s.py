"""audio_s_per_s: seconds of audio advanced through the model across all
streams, over the wall seconds of the whole window."""


def read(ctx):
    w = ctx.get("window") or {}
    if "audio_s" not in w:
        return None
    return w["audio_s"] / w["wall_s"]
