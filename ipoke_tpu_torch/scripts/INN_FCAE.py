"""Train the unconditioned flat INN on the frozen flow encoder's latents
(reference ``INN_FCAE.py``):

    python -m ipoke_tpu_torch.scripts.INN_FCAE [-c config/inn_fcae.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("inn_fcae", "config/inn_fcae.yaml"))
