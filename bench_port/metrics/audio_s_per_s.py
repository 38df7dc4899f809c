"""audio_s_per_s: audio seconds whose features the window returned, over its wall time."""


def read(ctx):
    return ctx.window["audio_s"] / ctx.window["seconds"]
