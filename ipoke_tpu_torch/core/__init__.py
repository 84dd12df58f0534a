"""Training support (counterpart of ``ipoke_tpu/core``): the config tree,
the optimizers and the checkpoint store."""
