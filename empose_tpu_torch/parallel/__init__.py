"""Data parallelism: device lists, batch padding and sharding, process groups."""
