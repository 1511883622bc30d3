"""``mfu.<cell kind>``: the whole step's share of the card's peak, %:
the reference backbone's FLOPs for the frames the window completed
(forward plus backward in training, forward otherwise) over the peak of
the cell's compute dtype (float32 outside the tensor cores, TF32 being
off; bf16 on them).  Training and offline batches divide by the
window's seconds; served traffic, whose rate is fixed, by the device's
busy seconds in the window (over the window it would echo the rate)."""


def read(ctx):
    if ctx.peaks is None or not ctx.window.get("frames"):
        return None
    kind = ctx.name.rsplit(".", 1)[1]
    flops = ctx.flops(kind == "train") * ctx.window["frames"]
    seconds = (ctx.trace.busy_s if kind == "serve"
               else ctx.trace.window_s)
    if seconds <= 0:
        return None
    return 100.0 * flops / seconds / ctx.peaks[ctx.run.dtype]
