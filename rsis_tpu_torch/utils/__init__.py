"""Utilities of the port: the training monitor."""
