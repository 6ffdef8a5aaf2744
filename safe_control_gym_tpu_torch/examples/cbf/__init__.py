"""The cbf examples of `examples/cbf/` on the port."""
