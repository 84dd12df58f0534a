"""Train the BigGAN autoencoder on frames (reference ``ImgAutoencoderFC.py``):

    python -m ipoke_tpu_torch.scripts.ImgAutoencoderFC [-c config/img_encoder_fc.yaml]
        [--model_name NAME] [--data_root PATH] [--debug] [--device cuda|cpu]
"""
import sys

from ipoke_tpu_torch.scripts import run

if __name__ == "__main__":
    sys.exit(run("flow_encoder_fc", "config/img_encoder_fc.yaml"))
