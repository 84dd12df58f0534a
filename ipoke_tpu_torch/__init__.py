"""ipoke_tpu_torch — the PyTorch/CUDA port of ``ipoke_tpu`` for NVIDIA Hopper.

The layout mirrors ``ipoke_tpu``: ``ipoke_tpu_torch/flows/macow.py`` is the
counterpart of ``ipoke_tpu/flows/macow.py``.  It covers the poke-conditioned
sampling pass (``models.second_stage.SecondStageModel.forward_sample``), the
second-stage NLL train step (``train.SecondStageTrainer``), the first-stage
VAE-GAN train step (``train.FirstStageTrainer``) and the conv third stage
(``models.third_stage``: hallucinated flow and video from flow;
``train.FlowVAETrainer``, ``train.FlowMotionTrainer``) and the FC tower
(``models.big_ae``, ``models.fc_stack``, ``models.fc_baseline``,
``flows.fc``) with its third stage (``models.third_stage.ThirdStageFC``,
``train.ThirdStageFCTrainer``), and trains the conv pipeline and the FC
tower stage by stage from the YAMLs through its own entry point,
``python -m ipoke_tpu_torch.main`` (``cli/``, ``data/``, ``eval/``;
``scripts/`` holds the FC root scripts' counterparts).  The TPU
kernels on those paths are hand-written Hopper kernels in ``ops/`` (CUDA C++
sources in ``csrc/``), each beside a plain PyTorch version.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
