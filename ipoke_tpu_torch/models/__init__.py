"""Models of the sampling path."""

from .first_stage import FirstStageModel
from .second_stage import SecondStageModel
