"""Training support (counterpart of ``ipoke_tpu/core``): the optimizers."""
