"""The first, second and (conv) third stage, and the FC tower
(``big_ae``, ``fc_stack``, ``fc_baseline``)."""

from .first_stage import FirstStageModel
from .second_stage import SecondStageModel
from .third_stage import ConvFlowVAE, FlowMotionModel
