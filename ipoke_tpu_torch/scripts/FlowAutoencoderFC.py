"""Train the BigGAN autoencoder (BigAE) on optical-flow maps (reference
``FlowAutoencoderFC.py``):

    python -m ipoke_tpu_torch.scripts.FlowAutoencoderFC [-c config/flow_encoder_fc.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("flow_encoder_fc", "config/flow_encoder_fc.yaml"))
