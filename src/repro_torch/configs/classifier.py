"""Classifier configs for the paper's own evaluation models (§V).

The QPART paper evaluates on a 6-fully-connected-layer MNIST classifier
(Fig. 4) plus CNN/ResNet image classifiers. These are *classifiers*, not
decoder LMs, so they get their own light config type. The QPART decision
layer consumes ``layer_specs()`` from either kind.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    """Fully connected layer: in_dim -> out_dim."""
    in_dim: int
    out_dim: int


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Conv layer: C_in x C_out, F1 x F2 filter over U x V input (Eq. 2)."""
    c_in: int
    c_out: int
    f1: int
    f2: int
    u: int
    v: int
    stride: int = 1
    pool: int = 1   # max-pool applied after activation


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str
    source: str
    input_shape: Tuple[int, ...]
    num_classes: int
    layers: Sequence[object]      # DenseSpec | ConvSpec, topologically ordered

    @property
    def num_layers(self) -> int:
        return len(self.layers)


# Paper Fig. 4: DNN with six fully connected layers for MNIST (28x28 -> 10).
MNIST_MLP = ClassifierConfig(
    name="mnist-mlp6",
    source="QPART paper Fig.4 (6 FC layers, MNIST)",
    input_shape=(28, 28),
    num_classes=10,
    layers=(
        DenseSpec(784, 512),
        DenseSpec(512, 256),
        DenseSpec(256, 128),
        DenseSpec(128, 64),
        DenseSpec(64, 32),
        DenseSpec(32, 10),
    ),
)

# Paper §V: "a CNN on SVHN/CIFAR10/CIFAR100" — a compact VGG-ish CNN.
CIFAR_CNN = ClassifierConfig(
    name="cifar-cnn",
    source="QPART paper §V (CNN on SVHN/CIFAR)",
    input_shape=(32, 32, 3),
    num_classes=10,
    layers=(
        ConvSpec(3, 32, 3, 3, 32, 32, pool=2),
        ConvSpec(32, 64, 3, 3, 16, 16, pool=2),
        ConvSpec(64, 128, 3, 3, 8, 8, pool=2),
        DenseSpec(128 * 4 * 4, 256),
        DenseSpec(256, 10),
    ),
)
