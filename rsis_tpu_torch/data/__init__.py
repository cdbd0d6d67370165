"""Data for the port: seeded synthetic wire batches."""
