"""Utilities of the port: the training monitor and its dashboard, the
train-log curves and profiling."""
