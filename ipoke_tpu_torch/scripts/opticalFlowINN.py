"""Train the conv third stage, the flow-to-residual bridge INN (reference
``opticalFlowINN.py``):

    python -m ipoke_tpu_torch.scripts.opticalFlowINN [-c config/flow_motion.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("flow_motion", "config/flow_motion.yaml"))
