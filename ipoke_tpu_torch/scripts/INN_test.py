"""Train the conv flow VAE's bridge INN (reference ``INN_test.py``, a
near-duplicate of the flow_motion stack):

    python -m ipoke_tpu_torch.scripts.INN_test [-c config/flow_motion.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("flow_motion", "config/flow_motion.yaml"))
