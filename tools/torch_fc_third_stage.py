#!/usr/bin/env python3
"""The FC third stage of ``config/third_stage_fc.yaml`` at its whole depth
(20 blocks: the 692.6M-param flat INN, mid 2048, B = 32, fp32) through the
port's CLI on one NVIDIA GPU, as ``chip_smoke.py`` phase (n) runs it at 6:
the kernels' build, the (m3) runs it loads (FC image and poke encoders, FC
first stage, FC second stage, at 32 px), then (n3) a 32 px flow encoder,
the third stage's epoch, its restore check and ``--resume``, and (n4)
``--test realism`` and ``accuracy`` and ``sample_video`` with its profile;
with ``--conditional`` instead one epoch of the YAML with
``general.conditional`` (three epochs at 20 blocks write more than the
card's machine lets one call write, 45 GiB).

    python3 tools/torch_fc_third_stage.py [--conditional]

Prints each run's record as ``chip_smoke.py`` does, then one JSON line of
the launches and numbers.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def conditional_run(dev, smi, tree):
    """A 32 px flow encoder, then one epoch of the YAML at 20 blocks with
    ``general.conditional`` (the INN conditioned on the poke embedding)."""
    import yaml

    path = cs.fc_cli_config(tree, "flow_encoder_fc_32", "flow_encoder_fc",
                            "flow_encoder_fc", True)
    e, _ = cs.drive_cli(dev, smi, tree["data_root"], "flow_encoder_fc", path)
    del e
    cs.release()
    path = cs.fc_cli_config(tree, "third_stage_fc_conditional", "third_stage_fc",
                            "third_stage_fc", True, {"n_flows": 20})
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["general"]["conditional"] = True
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    e, result = cs.drive_cli(dev, smi, tree["data_root"], "third_stage_fc", path)
    from ipoke_tpu_torch.flows import count_params

    result["inn_params"] = count_params(e.model.inn_params.tree())
    print(f"third_stage_fc conditioned on the poke embedding ({e.model.poke_cond_dim} "
          f"entries): {result['inn_params'] / 1e6:.2f}M params, one epoch")
    return {"fc_third_third_stage_fc_conditional": result["launches"]}, {
        "third_stage_fc_conditional": result}


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ipoke_tpu_torch.ops import _build

    _build.build()
    _build.load()
    with cs.cli_tree() as tree:
        for run, yaml_name, exp, cut in cs.FC_RUNS:
            if exp in ("flow_encoder_fc", "inn_fcae"):  # (n3) trains its own
                continue
            e, _ = cs.drive_cli(dev, smi, tree["data_root"], exp,
                                cs.fc_cli_config(tree, run, yaml_name, exp, cut))
            del e
            cs.release()
        if "--conditional" in sys.argv[1:]:
            launches, results, more, tests = *conditional_run(dev, smi, tree), {}, {}
        else:
            launches, results = cs.phase_fc_third_cli(dev, smi, tree, n_flows=20)
            more, tests = cs.phase_fc_third_test(dev, smi, tree, conditional=False)
    print(f"done in {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"launches": {**launches, **more}, "runs": results, "tests": tests},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
