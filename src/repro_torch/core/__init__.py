"""Framework-level pieces of the port: the sampler."""
