"""Device milliseconds a step in the MoE layers' routing: the port's regions
``gan_ffn.moe.route`` (router, top-k, sort, offsets, gather, combine) and
``gan_ffn.moe.route_backward``, each by its own stamps (end - begin, on the
device's clock), summed over the traced steps.  Nothing to read in a run
whose program has no such region."""


def read(ctx):
    routed = ctx.get("moe_route_s")
    if not routed or ctx["steps"] <= 0:
        return None
    return 1e3 * routed / ctx["steps"]
