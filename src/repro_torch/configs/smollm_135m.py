"""SmolLM-135M — llama-arch small dense model.

[hf:HuggingFaceTB/SmolLM-135M]: 30 layers, d_model=576, 9 query heads with
GQA kv=3, d_ff=1536, vocab 49152, tied embeddings, RMSNorm + SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, register

SMOLLM_135M = register(ModelConfig(
    name="smollm-135m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    tie_embeddings=True,
))
