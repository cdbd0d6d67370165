"""Data for the port: the host pipeline (catalogs, packed targets, the
loader), the device augmentation and seeded synthetic wire batches."""
