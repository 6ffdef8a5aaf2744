"""The rl examples of `examples/rl/` on the port."""
