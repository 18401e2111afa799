"""Alias module: the paper's MNIST 6-FC classifier lives in classifier.py."""
from repro_torch.configs.classifier import MNIST_MLP  # noqa: F401
