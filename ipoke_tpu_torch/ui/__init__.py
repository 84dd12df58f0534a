"""The interactive poke UI (counterpart of ``ipoke_tpu/ui``)."""
