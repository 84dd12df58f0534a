"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at a
small size, with each fault that the cell can have planted in the port
(one chip: no exchange between chips to leave out)."""

import pytest
import torch

from conftest import run_small, small_cell


def alter_one_answer(monkeypatch):
    """A sampled video altered where the pass produces it."""
    from ipoke_tpu_torch.models.second_stage import SecondStageModel

    sample = SecondStageModel.forward_sample

    def altered(self, *args, **kwargs):
        frames = sample(self, *args, **kwargs).clone()
        frames[-1] = frames[-1] * 0.5
        return frames
    monkeypatch.setattr(SecondStageModel, "forward_sample", altered)


def unit_inverse_unchanged(monkeypatch):
    """Every MaCowUnit's inverse (K2's path) returns its input, as a kernel
    that writes nothing would."""
    from ipoke_tpu_torch.ops import masked_conv

    monkeypatch.setattr(masked_conv, "macow_unit_inverse", lambda y, *a, **k: y.float())


def state_unchanged(monkeypatch):
    """Every optimizer step returns the state it was given."""
    from ipoke_tpu_torch.core import optim

    monkeypatch.setattr(optim._Adam, "step", lambda self: None)


def half_the_batch(monkeypatch):
    """The step takes the mean over the first half of the batch only."""
    from ipoke_tpu_torch.train import FirstStageTrainer

    step = FirstStageTrainer.train_step

    def half(self, batch, *args):
        n = batch["images"].shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, *args)
    monkeypatch.setattr(FirstStageTrainer, "train_step", half)


def alter_decoder(monkeypatch):
    """K3's SPADE modulation (the decoder's frames) off by a little."""
    from ipoke_tpu_torch.nn import blocks

    spade = blocks.spade_gn_modulate
    monkeypatch.setattr(blocks, "spade_gn_modulate", lambda *a, **k: spade(*a, **k) * 1.001)


@pytest.mark.parametrize("workload, fault", [
    ("cinn128_sample_div", alter_one_answer),
    ("cinn128_sample_div", unit_inverse_unchanged),
    ("fs64_train", state_unchanged),
    ("fs64_train", half_the_batch),
    ("fs64_train", alter_decoder),
])
def test_fault_is_not_correct(workload, fault, monkeypatch, capsys):
    torch.manual_seed(0)
    fault(monkeypatch)
    rc, result = run_small(small_cell(workload), capsys)
    assert rc == 0 and result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", ["cinn128_sample_div", "fs64_train"])
def test_sound_run_is_correct(workload, capsys):
    rc, result = run_small(small_cell(workload), capsys)
    assert rc == 0 and result["correct"] is True, result["checks"]
