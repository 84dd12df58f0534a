"""Synthetic inputs for the port's runs and tests."""

from .synthetic import make_batch
