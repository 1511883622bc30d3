"""``train.loader_wait_ms.<cell kind>``: the mean time of the program's
span ``pipeline.wait`` in the traced window, ms: the train loop waiting
on ``data/pipeline.py`` ``prefetch_to_device`` for its next staged
batch (near 0 while the loader and the stager keep ahead of the step)."""

from portbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "pipeline.wait")
