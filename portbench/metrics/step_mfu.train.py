"""The whole train step's share of the card's f32-accurate peak: the model
FLOPs of the traced steps (``lib/flops.py``) over the traced window by the
device's clock (its first device activity to its last), over 165 TFLOP/s."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["flops"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peaks"]["f32_accurate_flops"]
