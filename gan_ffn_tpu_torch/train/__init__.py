"""Stage B training: the optimizer, the classifier steps and the epoch loop."""
