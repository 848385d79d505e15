"""File formats the port reads and writes with its own code."""
