"""Shared building blocks (counterpart of ``groma_tpu/models/layers.py``).

``multi_head_attention`` takes the flash-attention kernels behind
``use_flash`` (ops/flash_attention.py) and the plain path otherwise.
``cast_linear``, ``linear`` and ``layer_norm`` run in the input's dtype
over parameters kept in another (f32 master weights, bf16 products, as
flax's ``dtype``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.ops.flash_attention import flash_attention


def _wide_linear(x, w, out_dtype):
    """x @ w.T, both of x's dtype, the products summed and returned in
    ``out_dtype``: on the card one tensor-core GEMM that writes
    ``out_dtype`` (``torch.mm``'s ``out_dtype``); elsewhere the product of
    the values cast up, which is exact for the narrower dtype's values."""
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=out_dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.to(out_dtype), w.to(out_dtype))


class _CastLinear(torch.autograd.Function):
    """x @ w.T with w cast to x's dtype for the product, the output in x's
    dtype or in a wider ``out_dtype`` (the products of x's dtype summed
    there).  The cast copy is not kept for the backward, which casts
    again: a frozen 7B LLM would otherwise hold a second, bf16 copy of its
    weights until the backward.  The gradients are taken in x's dtype,
    the weight's rounded to x's dtype first, as the transpose of flax's
    cast is."""

    @staticmethod
    def forward(ctx, x, w, out_dtype=None):
        # x is needed only for w's gradient: a frozen weight does not keep it
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        ctx.dtype = x.dtype
        if out_dtype is None or out_dtype == x.dtype:
            return F.linear(x, w.to(x.dtype))
        return _wide_linear(x, w.to(x.dtype), out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(ctx.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = gy @ w.to(gy.dtype)
        if ctx.needs_input_grad[1]:
            gw = (gy.reshape(-1, gy.shape[-1]).T
                  @ x.reshape(-1, x.shape[-1])).to(w.dtype)
        return gx, gw, None


def cast_linear(x, w, out_dtype=None):
    """Bias-free linear in x's dtype over a weight kept in another; with
    ``out_dtype``, the output in that (wider) dtype."""
    if w.dtype == x.dtype and out_dtype in (None, x.dtype):
        return F.linear(x, w)
    return _CastLinear.apply(x, w, out_dtype)


def linear(m: nn.Linear, x):
    """``m(x)`` in x's dtype."""
    y = cast_linear(x, m.weight)
    return y if m.bias is None else y + m.bias.to(x.dtype)


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


def layer_norm(m: nn.LayerNorm, x):
    """``m(x)`` with the weight and bias cast to x's dtype."""
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype),
                        m.bias.to(x.dtype), m.eps)


def multi_head_attention(q, k, v, num_heads: int, kv_mask=None,
                         causal: bool = False, use_flash: bool = False):
    """MHA over (B, S, D) projections, split into heads here; optional
    (B, S_kv) key mask and causal band.

    ``use_flash``: the flash-attention kernels.  Otherwise the plain path:
    bf16 inputs store the scores in bf16 with an f32 softmax (the JAX
    package's torch-autocast semantics); f32 inputs stay f32."""
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads

    def split(x, s):
        return x.reshape(b, s, num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q, sq), split(k, skv), split(v, skv)
    if use_flash:
        out = flash_attention(qh, kh, vh, kv_mask=kv_mask, causal=causal)
        return out.transpose(1, 2).reshape(b, sq, d).to(q.dtype)
    score_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 \
        else torch.float32
    s = torch.matmul(qh.to(score_dtype), kh.to(score_dtype).transpose(-1, -2))
    s = s * torch.tensor(hd ** -0.5, dtype=score_dtype)
    masked = torch.tensor(-1e30, dtype=score_dtype)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, masked)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(kj <= qi + (skv - sq), s, masked)
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
