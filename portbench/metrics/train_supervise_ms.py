"""``train.supervise_ms.<cell kind>``: the mean time of the program's
span ``train.supervise`` in the traced window, ms: the host enqueueing
every supervised stack's decode and its two losses, once a microbatch
(``training/steps.py``, around ``_losses``)."""

from portbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "train.supervise")
