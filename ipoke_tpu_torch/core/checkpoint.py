"""Checkpoint store: versioned run dirs + metric-gated best-k manifest
(counterpart of ``ipoke_tpu/core/checkpoint.py``).

The semantics are the JAX package's:

* run layout ``<base>/<experiment>/{ckpt,config,generated,log}/<model>/<ver>``
  with auto-incrementing integer versions;
* a ``best_k_models.yaml`` manifest mapping checkpoint path -> monitored
  metric, pruned to ``save_top_k`` by ``mode``, plus ``last``; checkpoints
  are named ``last`` and ``step=<n>-<monitor>=<v:.3f>``, each with an
  optional ``*_weights`` sidecar (the model-only tree that later stages
  load);
* ``best_path`` / ``restore_best(weights=...)`` pick the best checkpoint
  that still exists, else ``last``.

Storage is ``torch.save`` of a state tree (module state dicts with their
buffers, e.g. spectral-norm ``u``/``sigma``, optimizer states, step and
counts) into ``<name>/state.pt``, in place of orbax directories; tensors are
moved to the CPU first, so a checkpoint loads on any device.  Orbax
checkpoints of JAX runs are not readable here.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch
import yaml

_FILE = "state.pt"


def create_dir_structure(base_dir: str, experiment: str, model_name: str) -> Dict[str, str]:
    dirs = {}
    for sub in ("ckpt", "config", "generated", "log"):
        d = os.path.join(base_dir, experiment, sub, model_name)
        os.makedirs(d, exist_ok=True)
        dirs[sub] = d
    return dirs


def next_version(ckpt_dir: str) -> int:
    versions = [
        int(d) for d in os.listdir(ckpt_dir)
        if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))
    ] if os.path.isdir(ckpt_dir) else []
    return max(versions) + 1 if versions else 0


def latest_version(ckpt_dir: str) -> Optional[int]:
    versions = sorted(
        int(d) for d in os.listdir(ckpt_dir)
        if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))
    ) if os.path.isdir(ckpt_dir) else []
    # latest version that actually contains checkpoints
    for v in reversed(versions):
        vd = os.path.join(ckpt_dir, str(v))
        if os.listdir(vd):
            return v
    return None


def to_cpu(tree: Any) -> Any:
    """A copy of a state tree with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointStore:
    """``torch.save``-backed store for one run version."""

    def __init__(self, version_dir: str, monitor: str = "loss",
                 save_top_k: int = 3, mode: str = "min"):
        self.dir = os.path.abspath(version_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.mode = mode
        self.manifest_path = os.path.join(self.dir, "best_k_models.yaml")

    # -- manifest ------------------------------------------------------------
    def _load_manifest(self) -> Dict[str, float]:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                return yaml.safe_load(f) or {}
        return {}

    def _write_manifest(self, m: Dict[str, float]):
        with open(self.manifest_path, "w") as f:
            yaml.safe_dump(m, f)

    # -- save/restore ----------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @staticmethod
    def _save_one(path: str, tree: Any):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(tree, os.path.join(path, _FILE))

    def save(self, state: Any, step: int, metric: Optional[float] = None,
             is_last: bool = True, weights: Any = None) -> Optional[str]:
        """Save ``last``; when ``metric`` is given also save a monitored
        checkpoint and prune to top-k.  ``weights`` is an optional
        model-only tree saved as a ``*_weights`` sidecar."""
        state = to_cpu(state)
        weights = None if weights is None else to_cpu(weights)
        if is_last:
            self._save_one(self._path("last"), state)
            if weights is not None:
                self._save_one(self._path("last_weights"), weights)
        saved = None
        if metric is not None:
            name = f"step={step}-{self.monitor}={metric:.3f}"
            saved = self._path(name)
            self._save_one(saved, state)
            if weights is not None:
                self._save_one(saved + "_weights", weights)
            m = self._load_manifest()
            m[saved] = float(metric)
            # prune
            reverse = self.mode == "max"
            keep = sorted(m.items(), key=lambda kv: kv[1], reverse=reverse)
            for path, _ in keep[self.save_top_k:]:
                m.pop(path, None)
                for stale in (path, path + "_weights"):
                    if os.path.exists(stale):
                        shutil.rmtree(stale)
            self._write_manifest(m)
        return saved

    def restore(self, name: str = "last", map_location="cpu") -> Any:
        """The state tree saved under ``name`` (a name in this run, or an
        absolute path), its tensors on ``map_location``."""
        path = name if os.path.isabs(name) else self._path(name)
        return torch.load(os.path.join(path, _FILE), map_location=map_location,
                          weights_only=True)

    def best_path(self) -> Optional[str]:
        m = {p: v for p, v in self._load_manifest().items() if os.path.exists(p)}
        if not m:
            last = self._path("last")
            return last if os.path.exists(last) else None
        reverse = self.mode == "max"
        return sorted(m.items(), key=lambda kv: kv[1], reverse=reverse)[0][0]

    def restore_best(self, weights: bool = False, map_location="cpu") -> Any:
        path = self.best_path()
        assert path is not None, f"no checkpoints in {self.dir}"
        if weights:
            path = path + "_weights" if not path.endswith("last") \
                else self._path("last_weights")
        return self.restore(path, map_location)
