"""The grouped expert kernels' share of their roofline: the summed bounds of
the traced steps' ``grouped_swiglu`` launches (``lib/moe_counts.moe_step``:
the routed experts over k rows a routed row, the shared experts and the
dense layer over the rows the batch needs) over the device seconds of those
kernels and their reductions.  Nothing to read in a run whose program has no
such kernel."""


def read(ctx):
    spent, bound = ctx.get("moe_s"), ctx.get("moe_bound_s")
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
