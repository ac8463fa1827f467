"""Device milliseconds a step in kernels that are not the port's own
(cuBLAS, LayerNorm, elementwise ops, the DialogueRNN scan's)."""


def read(ctx):
    other = ctx["layer_s"].get("torch")
    if not other or ctx["steps"] <= 0:
        return None
    return 1e3 * other / ctx["steps"]
