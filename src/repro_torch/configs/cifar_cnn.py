"""Alias module: the paper's CIFAR CNN lives in classifier.py."""
from repro_torch.configs.classifier import CIFAR_CNN  # noqa: F401
