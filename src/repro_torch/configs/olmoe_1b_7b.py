"""OLMoE-1B-7B — 64-expert top-8 MoE with 1B active / 7B total params.

[arXiv:2409.02060]: 16 layers, d_model=2048, 16 heads (kv=16), per-expert
d_ff=1024, vocab 50304, MoE on every layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

OLMOE_1B_7B = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50_304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, every=1),
))
