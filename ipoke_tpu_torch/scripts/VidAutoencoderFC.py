"""Train the FC video baseline (reference ``VidAutoencoderFC.py``):

    python -m ipoke_tpu_torch.scripts.VidAutoencoderFC [-c config/first_stage_fc.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("first_stage_fc", "config/first_stage_fc.yaml"))
