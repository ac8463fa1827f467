"""The MLP kernels' share of their roofline: the summed bounds of the traced
steps' MLP launches (rows the batch needs, ``lib/flops.py``) over the device
seconds of the MLP kernels and their reduction kernels."""


def read(ctx):
    spent, bound = ctx["layer_s"].get("mlp"), ctx["bound_s"]["mlp"]
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
