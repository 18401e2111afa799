"""Model backends: everything architecture-specific behind one protocol.
The classifier backend is not ported yet (ROADMAP Queue 1)."""
from repro_torch.serving.backends.base import DeviceExecutor, ModelBackend  # noqa: F401
from repro_torch.serving.backends.transformer import TransformerBackend  # noqa: F401
