"""The first, second and third stages (conv and FC), the FC tower
(``big_ae``, ``fc_stack``, ``fc_baseline``) and the reference FCAE
(``biggan_compat``)."""

from .first_stage import FirstStageModel
from .second_stage import SecondStageModel
from .third_stage import ConvFlowVAE, FlowMotionModel
