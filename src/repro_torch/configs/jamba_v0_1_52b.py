"""Jamba-v0.1-52B — hybrid Mamba + attention (1:7) with 16-expert top-2 MoE.

[arXiv:2403.19887]: 32 layers, d_model=4096; attention blocks have 32 heads
(GQA kv=8, head_dim=128); Mamba blocks use d_state=16, expand=2; MoE
(16e top-2, d_ff=14336) every other layer; vocab 65536. One attention block
per period of 8 (1 attn : 7 mamba).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

JAMBA_V0_1_52B = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14_336, every=2),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4),
))
