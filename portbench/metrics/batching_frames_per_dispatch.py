"""``batching.frames_per_dispatch``: frames the program's
``BatchingPredictor`` sent to the device a dispatch in the window, from
its counters ``n_frames`` and ``n_dispatches``."""


def read(ctx):
    d = ctx.window.get("dispatches")
    if not d:
        return None
    return ctx.window["dispatch_frames"] / d
