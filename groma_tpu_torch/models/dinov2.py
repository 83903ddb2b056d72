"""DINOv2 ViT encoder, HF ``Dinov2Model`` semantics and parameter names
(counterpart of ``groma_tpu/models/dinov2.py``).

The position embedding is stored at the deployment grid (32x32 at 448),
as the weight bridge exports it.  ``forward`` returns
``(last_hidden_state, hidden_states)``: entry 0 of ``hidden_states`` is
the embedding output, entry i the output of layer i, none of them through
the final LayerNorm (Groma taps those).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu.config import ViTConfig
from groma_tpu_torch.models.layers import multi_head_attention


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

    def forward(self, pixel_values):
        """(B, H, W, 3) -> (B, 1 + G*G, C)."""
        x = self.patch_embeddings.projection(pixel_values.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings


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


class Dinov2Layer(nn.Module):
    def __init__(self, c: ViTConfig, device=None, dtype=None):
        super().__init__()
        if c.use_swiglu_ffn:
            raise ValueError('the SwiGLU FFN (dinov2-giant) is not ported')
        d = c.hidden_size
        self.num_heads = c.num_heads
        self.norm1 = nn.LayerNorm(d, eps=c.layer_norm_eps, device=device,
                                  dtype=dtype)
        self.attention = _Attention(d, device, dtype)
        self.layer_scale1 = _LayerScale(d, c.layerscale_value, device, dtype)
        self.norm2 = nn.LayerNorm(d, eps=c.layer_norm_eps, device=device,
                                  dtype=dtype)
        self.mlp = _Mlp(d, int(d * c.mlp_ratio), device, dtype)
        self.layer_scale2 = _LayerScale(d, c.layerscale_value, device, dtype)

    def forward(self, x):
        h = self.norm1(x)
        a = self.attention.attention
        attn = multi_head_attention(a.query(h), a.key(h), a.value(h),
                                    self.num_heads)
        attn = self.attention.output.dense(attn)
        x = x + attn * self.layer_scale1.lambda1
        h = self.norm2(x)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h)))
        return x + h * self.layer_scale2.lambda1


class _Encoder(nn.Module):
    def __init__(self, c: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(c, device, dtype)
                                   for _ in range(c.num_layers))


class Dinov2Model(nn.Module):
    def __init__(self, c: ViTConfig, deploy_image_size: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = c
        self.image_size = deploy_image_size or c.image_size
        grid = self.image_size // c.patch_size
        self.embeddings = _Embeddings(c, grid, device, dtype)
        self.encoder = _Encoder(c, device, dtype)
        self.layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device, dtype=dtype)

    def forward(self, pixel_values):
        b, hh, ww, _ = pixel_values.shape
        if hh != self.image_size or ww != self.image_size:
            raise ValueError(f'model built for {self.image_size}², got '
                             f'{hh}x{ww}')
        dtype = self.embeddings.cls_token.dtype
        x = self.embeddings(pixel_values.to(dtype))
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x)
            hidden_states.append(x)
        return self.layernorm(x), tuple(hidden_states)
