"""Model backends: everything architecture-specific behind one protocol.
The serving stack is model-agnostic; a backend owns the family's layer
specs, forward functions and quantized device-segment execution."""
from repro_torch.serving.backends.base import DeviceExecutor, ModelBackend  # noqa: F401
from repro_torch.serving.backends.classifier import ClassifierBackend  # noqa: F401
from repro_torch.serving.backends.transformer import TransformerBackend  # noqa: F401
