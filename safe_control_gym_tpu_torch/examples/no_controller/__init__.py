"""The no_controller examples of `examples/no_controller/` on the port."""
