"""DBRX-132B — fine-grained 16-expert top-4 MoE.

[hf:databricks/dbrx-base]: 40 layers, d_model=6144, 48 heads (GQA kv=8,
head_dim=128), per-expert d_ff=10752, vocab 100352, MoE on every layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

DBRX_132B = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100_352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10_752, every=1),
))
