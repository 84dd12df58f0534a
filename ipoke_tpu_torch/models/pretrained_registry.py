"""Pretrained-model registry: symbolic names -> run artifacts (a copy of
``ipoke_tpu/models/pretrained_registry.py``).

Replaces the reference's hardcoded checkpoint dictionaries
(``models/pretrained_models.py`` / ``pretrained_models_fc.py``) with a YAML
registry (``config/pretrained_models.yaml``):

    first_stage_models:
      plants_64: {config: <path>.yaml, ckpt: <version dir>}
    poke_embedder_models: {...}
    conditioner_models: {...}
    second_stage_models: {...}
    flow_encoder_models: {...}

Stage configs can then reference submodels by ``name:`` instead of explicit
config/ckpt paths (reference config/second_stage.yaml:10-23).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import yaml

_SECTION_FOR = {
    "first_stage": "first_stage_models",
    "conditioner": "conditioner_models",
    "poke_embedder": "poke_embedder_models",
    "second_stage": "second_stage_models",
    "flow_encoder": "flow_encoder_models",
    "flow_vae": "flow_vae_models",
}


def load_registry(path: Optional[str] = None) -> Dict:
    path = path or os.environ.get(
        "IPOKE_TPU_REGISTRY", os.path.join("config", "pretrained_models.yaml")
    )
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return yaml.safe_load(f) or {}


def resolve(section_name: str, section_cfg: Dict,
            registry: Optional[Dict] = None) -> Dict:
    """Fill a stage-config section's ``config``/``ckpt`` from the registry
    when it specifies a symbolic ``name`` (no-op when paths are explicit)."""
    if section_cfg.get("ckpt") or not section_cfg.get("name"):
        return section_cfg
    registry = registry if registry is not None else load_registry()
    table = registry.get(_SECTION_FOR.get(section_name, section_name), {})
    entry = table.get(section_cfg["name"])
    if entry is None:
        raise KeyError(
            f"model name {section_cfg['name']!r} not found in registry "
            f"section {_SECTION_FOR.get(section_name, section_name)!r}"
        )
    out = dict(section_cfg)
    out.update(entry)
    return out
