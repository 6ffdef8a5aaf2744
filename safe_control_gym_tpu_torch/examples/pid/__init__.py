"""The pid examples of `examples/pid/` on the port."""
