"""The lqr examples of `examples/lqr/` on the port."""
