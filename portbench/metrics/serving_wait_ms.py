"""``serving.wait_ms.<cell kind>``: the mean time of the program's span
``serving.wait`` in the traced window, ms: the Predictor's ``finalize``
waiting on the event recorded after a call's copy back, that is, the
host waiting on the device."""

from portbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "serving.wait")
