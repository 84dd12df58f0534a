"""The second-stage trainer's sequence (counterpart of
``ipoke_tpu/cli/experiments.py``, second stage, ``build`` and
``train_step``).

1. data-dependent init of the flow in fp32 on the first batch (``ddi``);
2. under the mixed recipe, params and frozen nets cast to bf16 (``start``);
3. the optimizer built then, so that its fp32 masters copy the post-DDI,
   bf16-rounded values;
4. every step casts the batch to bf16 (``make_second_stage_train_step``).

The caller runs 1 (``ddi``) and 2-3 (``start``) before the first
``train_step``, and may change the params between them (``entry.perturb``
in tests).
"""

from __future__ import annotations

from typing import Optional

import torch

from .core.optim import cast_floats, flow_adam, master_weights
from .models.second_stage import (
    SecondStageModel,
    create_second_stage_state,
    make_second_stage_train_step,
)


class SecondStageTrainer:
    def __init__(self, model: SecondStageModel, lr_schedule):
        self.model = model
        self.mixed = bool(model.config.get("training", {}).get(
            "mixed_prec_master", False))
        self.make_tx = lambda params: flow_adam(params, lr_schedule)
        self.tx = self._step = None

    def ddi(self, batch, generator: Optional[torch.Generator] = None) -> None:
        """fp32 data-dependent init on ``batch``, into the flow params."""
        new = self.model.ddi(cast_floats(batch, torch.float32), generator)
        self.model.flow_params.load_tree(new)

    def start(self) -> None:
        """Cast to bf16 under the mixed recipe, then build the optimizer."""
        if self.mixed:
            self.model.to(torch.bfloat16)
            make = lambda params: master_weights(params, self.make_tx)
        else:
            make = self.make_tx
        self.tx = create_second_stage_state(self.model, make)
        self._step = make_second_stage_train_step(self.model, self.tx)

    def train_step(self, batch, generator: Optional[torch.Generator] = None):
        if self.tx is None:
            raise RuntimeError("SecondStageTrainer.train_step before start()")
        return self._step(batch, generator)
