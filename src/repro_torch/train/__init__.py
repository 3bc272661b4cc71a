"""Training: the optimizer, checkpoints, fault tolerance and the loop."""
