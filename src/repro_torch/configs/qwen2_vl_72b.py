"""Qwen2-VL-72B — VLM language backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191]: 80 layers, d_model=8192, 64 heads (GQA kv=8,
head_dim=128), d_ff=29568, vocab 152064, QKV bias, M-RoPE (3-section
multimodal rotary embedding). The ViT vision encoder + projector is a stub
per the assignment — ``input_specs`` feeds precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

QWEN2_VL_72B = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="vision",
))
