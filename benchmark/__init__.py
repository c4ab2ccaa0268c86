"""The port's benchmark: a harness driven by data (see README.md)."""
