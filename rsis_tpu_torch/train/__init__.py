"""The training step of the port: state, losses, matcher, optimizers."""
