"""The first, second and (conv) third stage."""

from .first_stage import FirstStageModel
from .second_stage import SecondStageModel
from .third_stage import ConvFlowVAE, FlowMotionModel
