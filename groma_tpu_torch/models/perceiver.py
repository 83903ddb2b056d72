"""Perceiver: DINOv2 backbone + input-projection pyramid + DDETR head
(counterpart of ``groma_tpu/models/perceiver.py``).  Public tensors are
channels-last (B, H, W, C), as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.config import PerceiverConfig
from groma_tpu_torch.models.ddetr import DDETRTransformer
from groma_tpu_torch.models.dinov2 import Dinov2Model


class _Conv(nn.Conv2d):
    """Conv2d on channels-last tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _ConvT(nn.ConvTranspose2d):
    """ConvTranspose2d on channels-last tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)


class InputProj(nn.Sequential):
    """One pyramid level projection, the reference's Sequential layout.
    ``level`` is the recipe index before the reference reverses the list
    (0 = stride-2 down, 1 = identity, 2 = 2x up, 3 = 4x up); ``single`` is
    the one-level configuration (a 1x1 conv).  LayerNorm eps is 1e-6."""

    def __init__(self, in_dim: int, d: int, level: int, single: bool = False,
                 device=None):
        kw = dict(device=device)

        def ln(n):
            return nn.LayerNorm(n, eps=1e-6, **kw)

        if single or level == 1:
            mods = [_Conv(in_dim, d, 1, **kw), ln(d)]
        elif level == 0:
            mods = [_Conv(in_dim, d, 3, stride=2, padding=1, **kw), ln(d)]
        elif level == 2:
            mods = [_ConvT(in_dim, d // 2, 2, stride=2, **kw),
                    _Conv(d // 2, d, 1, **kw), ln(d),
                    _Conv(d, d, 3, padding=1, **kw)]
        elif level == 3:
            mods = [_ConvT(in_dim, d // 2, 2, stride=2, **kw), ln(d // 2),
                    _GELU(), _ConvT(d // 2, d // 4, 2, stride=2, **kw),
                    _Conv(d // 4, d, 1, **kw), ln(d),
                    _Conv(d, d, 3, padding=1, **kw)]
        else:
            raise ValueError('only up to 4 feature levels')
        super().__init__(*mods)


class Perceiver(nn.Module):
    def __init__(self, c: PerceiverConfig, device=None, vit_dtype=None,
                 vit_compute_dtype=None):
        super().__init__()
        self.cfg = c
        self.vis_encoder = Dinov2Model(c.vit, deploy_image_size=c.image_size,
                                       device=device, dtype=vit_dtype,
                                       compute_dtype=vit_compute_dtype)
        nfl = c.ddetr.num_feature_levels
        vd, d = c.vit.hidden_size, c.ddetr.d_model
        if nfl == 1:
            projs = [InputProj(vd, d, 1, single=True, device=device)]
        else:
            # the reference reverses the recipe list
            projs = [InputProj(vd, d, lvl, device=device)
                     for lvl in reversed(range(nfl))]
        self.input_proj = nn.ModuleList(projs)
        self.ddetr_transformer = DDETRTransformer(c.ddetr, device=device)

    def encode_image(self, images, use_flash: bool = False):
        """(B, H, W, 3) normalized pixels -> ViT hidden states;
        ``use_flash`` takes the bidirectional flash-attention kernel."""
        return self.vis_encoder(images, use_flash)[1]

    def ddetr_features(self, hidden_states):
        """Mean of the last-k hidden states, CLS dropped, as (B, h, w, C)."""
        k = self.cfg.vis_feature_layers
        feats = torch.stack(hidden_states[-k:]).mean(0)[:, 1:]
        b, l, d = feats.shape
        g = int(round(l ** 0.5))
        return feats.reshape(b, g, g, d)

    def propose(self, hidden_states, deterministic: bool = True,
                generator=None):
        """ViT hidden states -> DDETR outputs (boxes + dual objectness);
        ``deterministic=False`` turns the head's dropout on, drawn from
        ``generator``."""
        feat2d = self.ddetr_features(hidden_states)
        srcs = [proj(feat2d.to(torch.float32)) for proj in self.input_proj]
        return self.ddetr_transformer(srcs, deterministic, generator)

    def forward(self, images, use_flash: bool = False,
                deterministic: bool = True, generator=None):
        return self.propose(self.encode_image(images, use_flash),
                            deterministic, generator)
