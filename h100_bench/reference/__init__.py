"""Plain PyTorch references of the configurations: no kernel, no import of
the port or of JAX."""
