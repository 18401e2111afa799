from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS, INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape,
    ModelConfig, MoEConfig, SSMConfig, for_shape, get_config, list_configs,
    register,
)
from repro_torch.configs.classifier import CIFAR_CNN, MNIST_MLP  # noqa: F401
