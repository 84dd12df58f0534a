"""Conv building blocks, GRU, encoders and decoder of the sampling path."""

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
