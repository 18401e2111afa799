"""Qwen1.5-4B — dense with QKV bias, MHA (kv=heads).

[hf:Qwen/Qwen1.5-0.5B family, 4B point]: 40 layers, d_model=2560, 20 heads
(kv=20, head_dim=128), d_ff=6912, vocab 151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN1_5_4B = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
))
