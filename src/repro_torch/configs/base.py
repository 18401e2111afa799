"""Config system: architecture descriptions + input-shape suite + registry.

Every assigned architecture is a ``ModelConfig`` (one module per arch under
``repro/configs``). Configs are pure data — models are built from them by
``repro.models.transformer.Transformer``; the QPART decision layer reads
``layer_specs()`` derived from the same config, so the paper's algorithms
apply uniformly across families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Block kinds making up a decoder stack.
ATTN = "attn"
MAMBA = "mamba"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    every: int = 1               # MoE replaces the MLP every `every`-th block
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256             # SSD chunk length for the blocked scan

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str                  # citation for the config values
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int                    # dense-MLP hidden (0 if none / MoE-only)
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads
    rope: str = "rope"           # rope | rope2d | mrope | none
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1          # hybrid: 1 attention block per `attn_every`
                                 # blocks, the rest are mamba blocks.
                                 # attn_every=0 -> attention-free (pure SSM).
    sliding_window: Optional[int] = None   # None = full causal attention
    frontend: str = "none"       # none | audio | vision  (stub embeddings)
    dtype: str = "bfloat16"

    # TP head padding (Megatron/MaxText practice): query heads are padded
    # to a multiple of the model-axis size so the head dim shards evenly;
    # padded heads are masked to exact zero in the output projection, so
    # the function computed is exactly the unpadded architecture's.
    tp_pad: int = 16             # model-axis size to pad heads for (1 = off)

    # ---- derived -----------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def padded_vocab(self) -> int:
        """Vocab rounded up to the model-axis multiple (Megatron practice);
        padded logit columns are masked to -inf in the unembed."""
        if self.tp_pad <= 1:
            return self.vocab_size
        r = self.vocab_size % self.tp_pad
        return self.vocab_size + (self.tp_pad - r if r else 0)

    def padded_heads(self) -> "tuple[int, int]":
        """(KV_pad, G_pad): smallest padded GQA grouping with
        KV_pad*G_pad % tp_pad == 0, KV_pad >= KV, G_pad >= G."""
        kv = self.num_kv_heads
        g = max(self.num_heads // max(kv, 1), 1)
        if self.tp_pad <= 1 or (kv * g) % self.tp_pad == 0:
            return kv, g
        best = None
        for kvp in range(kv, kv + self.tp_pad + 1):
            for gp in range(g, g + self.tp_pad + 1):
                if (kvp * gp) % self.tp_pad == 0:
                    if best is None or kvp * gp < best[0] * best[1]:
                        best = (kvp, gp)
        return best

    def block_kind(self, layer: int) -> str:
        """Which block occupies position `layer` (0-based) of the stack."""
        if self.attn_every == 0:
            return MAMBA
        if self.attn_every == 1:
            return ATTN
        # Jamba-style: one attention block per period, at the middle slot.
        return ATTN if layer % self.attn_every == self.attn_every // 2 else MAMBA

    def uses_moe(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every == self.moe.every - 1)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        total += self.d_model  # final norm
        for l in range(self.num_layers):
            total += self._block_params(l)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k only)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        total += self.d_model
        for l in range(self.num_layers):
            total += self._block_params(l, active=True)
        return total

    def _block_params(self, layer: int, active: bool = False) -> int:
        d = self.d_model
        n = 0
        if self.block_kind(layer) == ATTN:
            hd = self.resolved_head_dim()
            n += d * self.num_heads * hd            # q
            n += 2 * d * self.num_kv_heads * hd     # k, v
            n += self.num_heads * hd * d            # o
            if self.qkv_bias:
                n += (self.num_heads + 2 * self.num_kv_heads) * hd
            n += d                                   # pre-norm
        else:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            n += d * (2 * di + 2 * s.d_state + nh)   # in_proj (x,z,B,C,dt)
            n += s.conv_width * (di + 2 * s.d_state) # conv over x,B,C
            n += nh * 2                              # A_log, D
            n += di * d                              # out_proj
            n += d                                   # pre-norm
        # feed-forward half
        if self.uses_moe(layer):
            m = self.moe
            per_expert = 3 * d * m.d_ff if self.mlp == "swiglu" else 2 * d * m.d_ff
            n += (m.top_k if active else m.num_experts) * per_expert
            n += d * m.num_experts                   # router
            n += d
        elif self.d_ff:
            n += (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
            n += d
        return n

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        hd = 64
        heads = max(1, min(self.num_heads, d // hd)) if self.num_heads else 0
        kv = max(1, min(self.num_kv_heads, heads)) if heads else 0
        # keep the GQA ratio flavour when possible
        if heads and self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 2 * d))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        # Hybrids keep both block kinds in 2 layers by tightening the
        # interleave to 1:1 (layer 0 mamba, layer 1 attention).
        attn_every = 2 if self.attn_every > 1 else self.attn_every
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=2, d_model=d,
            attn_every=attn_every, tp_pad=1,
            num_heads=heads, num_kv_heads=kv, head_dim=hd if heads else 0,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moe=moe, ssm=ssm,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )


# ---------------------------------------------------------------------------
# Input-shape suite (assigned).
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}

# Sliding window used when a full-attention arch is asked for long_500k.
LONG_CONTEXT_WINDOW = 4_096


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt a config to an input shape (sub-quadratic variant for 500k)."""
    if shape.name == "long_500k" and cfg.attn_every >= 1 and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


# ---------------------------------------------------------------------------
# Registry.
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_ARCH_MODULES = [
    "smollm_135m", "olmoe_1b_7b", "qwen3_14b", "musicgen_medium",
    "mamba2_1_3b", "qwen2_vl_72b", "dbrx_132b", "chatglm3_6b",
    "qwen1_5_4b", "jamba_v0_1_52b", "mnist_mlp", "cifar_cnn",
]

ASSIGNED_ARCHS = [
    "smollm-135m", "olmoe-1b-7b", "qwen3-14b", "musicgen-medium",
    "mamba2-1.3b", "qwen2-vl-72b", "dbrx-132b", "chatglm3-6b",
    "qwen1.5-4b", "jamba-v0.1-52b",
]


def _load_all() -> None:
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
