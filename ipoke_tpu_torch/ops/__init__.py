"""Kernel layer of the port: one hand-written Hopper kernel per TPU kernel on
the sampling and training paths, each beside a plain PyTorch version of the
same function.

* ``nice_net`` (K1, CUDA C++ ``csrc/nice_net.cu``) replaces
  ``ipoke_tpu/ops/nice_net.py::nice_net_raw_pallas``;
* ``nice_net_train`` (K4, the same CUDA source, with its autograd backward in
  ``ops/nice_net.py``) replaces ``ipoke_tpu/ops/nice_net.py::_train_impl``,
  the forward rule of ``nice_net_raw_train``; K1 and K4 also run at a mesh
  rank's shard of the hidden width (``parallel``);
* ``masked_conv`` (K2, CUDA C++ ``csrc/macow_unit_inverse.cu``) replaces
  ``ipoke_tpu/ops/masked_conv.py::macow_unit_inverse_pallas``;
* ``masked_conv`` (K5, CUDA C++ ``csrc/masked_conv_inverse.cu``) replaces
  ``ipoke_tpu/ops/masked_conv.py::masked_conv_inverse_pallas``, for the
  units whose latent K2 cannot hold (``unit_fits``): register, wide and
  streamed instances, so it takes every affine/ELU flow;
* ``spade_gn`` (K3, CUDA C++ ``csrc/spade_gn.cu``, with the portable
  backward of ``spade_gn_fused`` on the card) replaces
  ``ipoke_tpu/ops/spade_gn.py::spade_gn_modulate_pallas``.

Dispatch is by device: a wrapper given CPU tensors runs the plain version; on
CUDA tensors it launches its kernel or raises - there is no fallback.  As in
the JAX package, K1, K2 and K5 have no backward: on the card they raise
while autograd records through an input that requires grad
(``_build.refuse_grad``) rather than return an output without a gradient.
``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels.
"""

LAUNCHES = {"nice_net": 0, "nice_net_train": 0, "macow_unit_inverse": 0,
            "masked_conv_inverse": 0, "spade_gn": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
