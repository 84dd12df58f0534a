"""Evaluation metrics (counterpart of ``ipoke_tpu/eval``): the optical-flow
errors the third-stage trainers monitor."""

from .metrics import angular_error, endpoint_error
