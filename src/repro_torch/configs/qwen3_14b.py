"""Qwen3-14B — dense with qk-norm and GQA.

[hf:Qwen/Qwen3-8B family, 14B point]: 40 layers, d_model=5120, 40 heads
(GQA kv=8, head_dim=128), d_ff=17408, vocab 151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_14B = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
