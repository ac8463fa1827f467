"""Training: stage A (the adversarial engine), stage B (the classifier
steps and the epoch loop) and the optimizer."""
