"""Conv building blocks, GRU, encoders, decoder and motion encoder."""

from .blocks import (
    Conv,
    Conv2dBlock,
    Conv2dTransposeBlock,
    ConvTranspose,
    GroupNorm,
    ResBlock,
    Spade,
    make_norm,
    resize_bilinear,
)
from .encoders import ConvEncoder, FirstStageWrapper, SpadeCondConvDecoder
from .gru import ConvGRU, ConvGRUCell
from .motion import BasicBlock3d, Conv3d, ResNetMotionEncoder
