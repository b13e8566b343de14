"""Traffic kinds, one module a kind, loaded by name."""
