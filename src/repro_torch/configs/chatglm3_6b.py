"""ChatGLM3-6B — dense, 2d-RoPE (partial rotary), extreme GQA (kv=2).

[arXiv:2406.12793]: 28 layers, d_model=4096, 32 heads (GQA kv=2,
head_dim=128), d_ff=13696, vocab 65024, QKV bias, rotary applied to half
the head dims (GLM's 2d RoPE).
"""
from repro_torch.configs.base import ModelConfig, register

CHATGLM3_6B = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=65_024,
    qkv_bias=True,
    rope="rope2d",
))
