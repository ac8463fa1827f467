"""The yardstick: data generation, weights, counts, trace reduction and checks."""


class RunError(RuntimeError):
    """A run that cannot report a result."""
