"""DINOv2 ViT encoder, HF ``Dinov2Model`` semantics and parameter names
(counterpart of ``groma_tpu/models/dinov2.py``).

The position embedding is stored at the deployment grid (32x32 at 448),
as the weight bridge exports it.  ``forward`` returns
``(last_hidden_state, hidden_states)``: entry 0 of ``hidden_states`` is
the embedding output, entry i the output of layer i, none of them through
the final LayerNorm (Groma taps those).

Parameters may be kept in another dtype than the one the layers compute
in (``compute_dtype``): a trainer keeps f32 weights and runs bf16, as the
JAX package's f32 params with ``cfg.dtype`` do.  ``use_flash`` routes the
attention through the bidirectional flash-attention kernel.  With
``use_swiglu_ffn`` (DINOv2-giant) each layer's FFN is the SwiGLU one
(``mlp.weights_in`` / ``mlp.weights_out``, HF's names).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.config import ViTConfig
from groma_tpu_torch.models.layers import (layer_norm, linear,
                                           multi_head_attention)


class _PatchEmbeddings(nn.Module):
    def __init__(self, c: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.projection = nn.Conv2d(c.num_channels, c.hidden_size,
                                    c.patch_size, stride=c.patch_size,
                                    device=device, dtype=dtype)


class _Embeddings(nn.Module):
    def __init__(self, c: ViTConfig, grid: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size, **kw))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, 1 + grid * grid, c.hidden_size, **kw))
        self.patch_embeddings = _PatchEmbeddings(c, device, dtype)

    def forward(self, pixel_values, dtype):
        """(B, H, W, 3) -> (B, 1 + G*G, C) in ``dtype``."""
        proj = self.patch_embeddings.projection
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2).to(dtype),
                     proj.weight.to(dtype), proj.bias.to(dtype),
                     stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings.to(dtype)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.query = nn.Linear(d, d, device=device, dtype=dtype)
        self.key = nn.Linear(d, d, device=device, dtype=dtype)
        self.value = nn.Linear(d, d, device=device, dtype=dtype)


class _SelfOutput(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(d, d, device=device, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.attention = _SelfAttention(d, device, dtype)
        self.output = _SelfOutput(d, device, dtype)


class _LayerScale(nn.Module):
    def __init__(self, d: int, value: float, device=None, dtype=None):
        super().__init__()
        self.lambda1 = nn.Parameter(
            torch.full((d,), value, device=device, dtype=dtype))


class _Mlp(nn.Module):
    def __init__(self, d: int, inner: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d, inner, device=device, dtype=dtype)
        self.fc2 = nn.Linear(inner, d, device=device, dtype=dtype)

    def forward(self, h):
        return linear(self.fc2, F.gelu(linear(self.fc1, h)))


class _SwiGLUFFN(nn.Module):
    """DINOv2-giant's FFN (HF ``Dinov2SwiGLUFFN``): silu(x1) * x2 of one
    fused input projection, the hidden width ``inner * 2 // 3`` rounded up
    to a multiple of 8, as the JAX package rounds it."""

    def __init__(self, d: int, inner: int, device=None, dtype=None):
        super().__init__()
        hidden = (inner * 2 // 3 + 7) // 8 * 8
        self.weights_in = nn.Linear(d, 2 * hidden, device=device,
                                    dtype=dtype)
        self.weights_out = nn.Linear(hidden, d, device=device, dtype=dtype)

    def forward(self, h):
        h1, h2 = linear(self.weights_in, h).chunk(2, dim=-1)
        return linear(self.weights_out, F.silu(h1) * h2)


class Dinov2Layer(nn.Module):
    def __init__(self, c: ViTConfig, device=None, dtype=None):
        super().__init__()
        d = c.hidden_size
        self.num_heads = c.num_heads
        self.norm1 = nn.LayerNorm(d, eps=c.layer_norm_eps, device=device,
                                  dtype=dtype)
        self.attention = _Attention(d, device, dtype)
        self.layer_scale1 = _LayerScale(d, c.layerscale_value, device, dtype)
        self.norm2 = nn.LayerNorm(d, eps=c.layer_norm_eps, device=device,
                                  dtype=dtype)
        ffn = _SwiGLUFFN if c.use_swiglu_ffn else _Mlp
        self.mlp = ffn(d, int(d * c.mlp_ratio), device, dtype)
        self.layer_scale2 = _LayerScale(d, c.layerscale_value, device, dtype)

    def forward(self, x, use_flash: bool = False):
        """x in the compute dtype."""
        dt = x.dtype
        h = layer_norm(self.norm1, x)
        a = self.attention.attention
        attn = multi_head_attention(linear(a.query, h), linear(a.key, h),
                                    linear(a.value, h), self.num_heads,
                                    use_flash=use_flash)
        attn = linear(self.attention.output.dense, attn)
        x = x + attn * self.layer_scale1.lambda1.to(dt)
        h = self.mlp(layer_norm(self.norm2, x))
        return x + h * self.layer_scale2.lambda1.to(dt)


class _Encoder(nn.Module):
    def __init__(self, c: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(c, device, dtype)
                                   for _ in range(c.num_layers))


class Dinov2Model(nn.Module):
    def __init__(self, c: ViTConfig, deploy_image_size: Optional[int] = None,
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        self.cfg = c
        self.compute_dtype = compute_dtype or dtype or torch.float32
        self.image_size = deploy_image_size or c.image_size
        grid = self.image_size // c.patch_size
        self.embeddings = _Embeddings(c, grid, device, dtype)
        self.encoder = _Encoder(c, device, dtype)
        self.layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device, dtype=dtype)

    def forward(self, pixel_values, use_flash: bool = False):
        b, hh, ww, _ = pixel_values.shape
        if hh != self.image_size or ww != self.image_size:
            raise ValueError(f'model built for {self.image_size}², got '
                             f'{hh}x{ww}')
        x = self.embeddings(pixel_values, self.compute_dtype)
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, use_flash)
            hidden_states.append(x)
        return layer_norm(self.layernorm, x), tuple(hidden_states)
