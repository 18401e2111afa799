"""Modality frontend stubs, as in the reference: the ViT / EnCodec
encoders are not implemented; the decoder takes precomputed frame or
patch embeddings of the right shape (``embeds=``), and these helpers
make matching synthetic tensors."""
from __future__ import annotations

import torch


def stub_embeddings(generator: torch.Generator, cfg, batch: int, seq: int,
                    dtype=torch.bfloat16):
    """Precomputed frontend output: (B, S, D) embeddings on the
    generator's device.

    audio  -> EnCodec frame embeddings (MusicGen consumes codebook tokens;
              the decoder sees summed codebook embeddings, same shape).
    vision -> ViT patch embeddings after the projector (Qwen2-VL).
    """
    scale = cfg.d_model ** -0.5
    return scale * torch.randn((batch, seq, cfg.d_model), generator=generator,
                               dtype=dtype, device=generator.device)


def mrope_positions(batch: int, seq: int, image_grid=(16, 16),
                    device="cuda"):
    """Qwen2-VL M-RoPE position triples (t, h, w) for a text+image stream.

    The first ``h*w`` tokens are image patches laid out on a 2-D grid at
    t = 0, the rest are text tokens with t advancing and h = w = t
    (Qwen2-VL rule). -> (3, B, S) int32.
    """
    gh, gw = image_grid
    n_img = min(gh * gw, seq)
    idx = torch.arange(seq, device=device)
    img_h = (idx % (gh * gw)) // gw
    img_w = idx % gw
    text_t = idx - n_img + 1  # starts at 1 after the image
    is_text = idx >= n_img
    t = torch.where(is_text, text_t, 0)
    h = torch.where(is_text, text_t, img_h)
    w = torch.where(is_text, text_t, img_w)
    pos = torch.stack([t, h, w]).to(torch.int32)            # (3, S)
    return pos[:, None, :].expand(3, batch, seq)
