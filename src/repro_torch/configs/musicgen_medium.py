"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284]: 48 layers, d_model=1536, 24 heads (MHA, kv=24),
d_ff=6144, vocab 2048 (EnCodec codebook). GeLU MLP + LayerNorm (the
original is a vanilla transformer decoder). The EnCodec conv frontend is a
stub per the assignment — ``input_specs`` feeds precomputed frame
embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

MUSICGEN_MEDIUM = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp="gelu",
    norm="layernorm",
    frontend="audio",
))
