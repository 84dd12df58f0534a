"""Conv building blocks, GRU, encoders, decoder, motion encoder,
discriminators, VGG and the RAFT flow estimator."""

from .blocks import (
    BatchNorm,
    Conv,
    Conv2dBlock,
    Conv2dTransposeBlock,
    ConvTranspose,
    ConvTransposeTK,
    GroupNorm,
    NormConv2d,
    ResBlock,
    Spade,
    SpectralNormed,
    make_norm,
    resize_bilinear,
    resize_bilinear_align_corners,
)
from .discriminators import (
    PatchDiscriminator2D,
    ResNet3DDiscriminator,
    adaptive_disc_weight,
    bce_d_loss,
    fmap_loss,
    gen_loss,
    gradient_penalty,
    hinge_d_loss,
)
from .encoders import (
    ConvDecoder,
    ConvEncoder,
    FirstStageWrapper,
    SpadeCondConvDecoder,
)
from .gru import ConvGRU, ConvGRUCell
from .motion import BasicBlock3d, Conv3d, ResNetMotionEncoder
from .raft import RAFT, RAFTConfig, load_torch_raft_npz, raft_estimator
from .vgg import VGG19Features, vgg_loss
