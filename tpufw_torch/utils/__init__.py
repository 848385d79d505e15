"""Device helpers and the accelerator spec table."""
