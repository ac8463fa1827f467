"""The share of the traced window, by the device's clock (its first device
activity to its last), in which no kernel and no copy ran on the card."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
