"""The attention kernels' share of their roofline: the summed bounds of the
traced steps' attention launches (``lib/flops.py``) over their device seconds."""


def read(ctx):
    spent, bound = ctx["layer_s"].get("attention"), ctx["bound_s"]["attention"]
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
