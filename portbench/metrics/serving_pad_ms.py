"""``serving.pad_ms.<cell kind>``: the mean time of the program's span
``serving.pad`` in the traced window, ms: ``Predictor._frames_on_device``
padding a call's raw frames to its bucket in pinned memory (the host
work before the upload)."""

from portbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "serving.pad")
