"""The hpo examples of `examples/hpo/` on the port."""
