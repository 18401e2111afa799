"""Mamba2-1.3B — attention-free SSM using SSD (state-space duality).

[arXiv:2405.21060]: 48 layers, d_model=2048, expand=2 (d_inner=4096),
ssm_state=128, head_dim=64 (64 SSD heads), conv width 4, vocab 50280.
No MLP (d_ff=0): every block is a Mamba2 mixer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

MAMBA2_1_3B = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    rope="none",
    attn_every=0,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
))
