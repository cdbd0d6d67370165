"""Training in the port: the step (state, losses, matcher, optimizers),
checkpoints and the epoch loop."""
