"""The Moonlight stage-A step's share of the card's f32-accurate peak: the
model FLOPs of the traced steps (``lib/moe_counts.stage_a_moonlight``: every
network, the text generator's four forwards and two backward passes among
them) over the traced window by the device's clock (its first device
activity to its last), over 165 TFLOP/s: the arithmetic of
``step_mfu.train``."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["flops"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peaks"]["f32_accurate_flops"]
