"""Shared building blocks (counterpart of ``groma_tpu/models/layers.py``).

``multi_head_attention`` is the plain, unmasked path its port callers
use: the flash-attention kernel behind ``use_flash`` is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    """ReLU-intermediate MLP head (HF DeformableDetrMLPPredictionHead);
    parameters ``layers.{i}``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, device=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device)
            for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def multi_head_attention(q, k, v, num_heads: int):
    """Plain MHA over (B, S, D) projections, split into heads here.

    bf16 inputs store the scores in bf16 with an f32 softmax (the JAX
    package's torch-autocast semantics); f32 inputs stay f32."""
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads

    def split(x, s):
        return x.reshape(b, s, num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q, sq), split(k, skv), split(v, skv)
    score_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 \
        else torch.float32
    s = torch.matmul(qh.to(score_dtype), kh.to(score_dtype).transpose(-1, -2))
    s = s * torch.tensor(hd ** -0.5, dtype=score_dtype)
    p = torch.softmax(s.to(torch.float32), dim=-1)
    out = torch.matmul(p.to(v.dtype), vh)
    return out.transpose(1, 2).reshape(b, sq, d).to(q.dtype)


def sine_position_embedding_2d(h: int, w: int, dim: int,
                               device=None) -> torch.Tensor:
    """(h, w, dim) sine/cosine encoding, HF DeformableDetr semantics with
    an all-valid mask (temperature 1e4, normalized to 2 pi); y first,
    then x."""
    half = dim // 2
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y = y.expand(h, w) / (h + eps) * scale
    x = x.expand(h, w) / (w + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / half)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, half)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, half)
    return torch.cat([pos_y, pos_x], dim=-1)


def proposal_position_embedding(proposals: torch.Tensor,
                                num_pos_feats: int = 128) -> torch.Tensor:
    """Position embedding of (..., 4) proposal logits, after sigmoid
    (temperature 1e4)."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=proposals.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos = torch.sigmoid(proposals) * (2 * math.pi)
    pos = pos[..., None] / dim_t                            # (..., 4, F)
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1)
    return pos.reshape(*proposals.shape[:-1], 4 * num_pos_feats)
