"""train_audio_s_per_s: audio seconds that the window's completed train steps consumed, over its wall time."""


def read(ctx):
    return ctx.window["audio_s"] / ctx.window["seconds"]
