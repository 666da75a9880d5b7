"""Training: losses, the train step and loop, validation, optimizers."""
