"""The mpc examples of `examples/mpc/` on the port."""
