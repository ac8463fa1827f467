"""Utilities: the weight bridge between JAX params and the port's modules,
the checkpoints in the JAX package's msgpack format (and the reader and
writer of that format), stage A's loss-history artifacts, TensorBoard
logging and profiling."""
