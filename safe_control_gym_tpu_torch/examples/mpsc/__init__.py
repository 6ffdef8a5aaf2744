"""The mpsc examples of `examples/mpsc/` on the port."""
