"""Per cent of the sample slots a round computes that hold a real sample:
the round rows' real samples over clients × packed steps × batch × epochs.
The rest is the packer's padding of the smaller silos up to the largest."""


def read(ctx):
    if not ctx.rows:
        return None
    t = ctx.traffic
    slots = len(ctx.rows) * ctx.steps_per_round * t["batch_size"]
    return 100.0 * ctx.units / slots
