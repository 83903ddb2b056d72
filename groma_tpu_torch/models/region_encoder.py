"""Region tokenizer: multi-level fusion + RoIAlign -> region tokens
(counterpart of ``groma_tpu/models/region_encoder.py``), under the
reference's parameter names (``mlvl_fuse.*``, ``roi_align.*``).

Kept from the JAX package, which keeps them from the reference:
* the last-3 ViT hidden states are upsampled (bilinear, align_corners) to
  4x, 2x and 1x of the base grid, and gain two coord-conv channels;
* rounds of cross-level channel-shuffle fusion, each a 3x3 no-bias conv,
  GroupNorm and ReLU;
* THE cxcywh-as-xyxy quirk: RoIAlign gets ``boxes * image_size`` as
  (x1, y1, x2, y2) although the boxes are normalized cxcywh, as the
  released checkpoints were trained;
* RoIAlign strides 14/8, 14/4, 14/2, which overshoot the feature sizes 2x;
* fp32 islands: RoIAlign and the box-position MLP run in f32 inside a bf16
  model.
Left out: the sharding constraints and the int8 vision-conv option.
Convolutions run channels-first (torch's layout); RoIAlign takes the JAX
package's channels-last layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.ops.roi_align import roi_align_batched

ROI_STRIDES = (14 / 8, 14 / 4, 14 / 2)


def resize_bilinear_align_corners(x, out_hw, dtype=torch.float32):
    """NCHW bilinear resize with align_corners=True, computed in ``dtype``
    (same size is the identity)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x.to(dtype)
    return F.interpolate(x.to(dtype), size=tuple(out_hw), mode='bilinear',
                         align_corners=True)


class ConvModuleGN(nn.Module):
    """mmcv ConvModule: 3x3 conv without bias -> GroupNorm -> ReLU."""

    def __init__(self, d: int, groups: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(d, d, 3, padding=1, bias=False, device=device,
                              dtype=dtype)
        self.gn = nn.GroupNorm(groups, d, eps=1e-5, device=device,
                               dtype=dtype)

    def forward(self, x):
        x = self.conv(x)
        x = F.group_norm(x.to(torch.float32), self.gn.num_groups,
                         self.gn.weight.to(torch.float32),
                         self.gn.bias.to(torch.float32), self.gn.eps)
        return torch.relu(x).to(self.conv.weight.dtype)


class MLVLFuse(nn.Module):
    def __init__(self, d: int = 1024, num_levels: int = 3, num_fuse: int = 5,
                 gn_groups: int = 64, device=None, dtype=None):
        super().__init__()
        self.num_levels = num_levels
        self.input_conv = nn.ModuleList(
            nn.Conv2d(d + 2, d, 1, device=device, dtype=dtype)
            for _ in range(num_levels))
        self.fuse_convs = nn.ModuleList(
            ConvModuleGN(d, gn_groups, device, dtype)
            for _ in range(num_fuse))

    def forward(self, feats):
        """List of (B, C, H, W) maps, largest first -> fused maps."""
        dtype = self.input_conv[0].weight.dtype
        withcoord = []
        for conv, f in zip(self.input_conv, feats):
            b, _, h, w = f.shape
            xs = torch.linspace(-1.0, 1.0, w, device=f.device)
            ys = torch.linspace(-1.0, 1.0, h, device=f.device)
            coord = torch.stack([xs[None, :].expand(h, w),
                                 ys[:, None].expand(h, w)], 0)
            coord = coord[None].expand(b, -1, -1, -1).to(dtype)
            withcoord.append(conv(torch.cat([f.to(dtype), coord], dim=1)))
        feats = withcoord
        d = feats[0].shape[1]
        shuffle = d // 4
        remain = d - 2 * shuffle
        n = self.num_levels
        for conv in self.fuse_convs:
            fused = []
            for lvl in range(n):
                top, down = min(lvl + 1, n - 1), max(lvl - 1, 0)
                tar = feats[lvl]
                hw = tar.shape[-2:]
                from_top = resize_bilinear_align_corners(
                    feats[top][:, remain + shuffle:], hw).to(dtype)
                from_down = resize_bilinear_align_corners(
                    feats[down][:, remain:remain + shuffle], hw).to(dtype)
                fused.append(conv(torch.cat([tar[:, :remain], from_top,
                                             from_down], dim=1)))
            feats = fused
        return feats


class _RoIHead(nn.Module):
    def __init__(self, d, out_dims, roi_out, num_levels, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pconvs = nn.ModuleList(nn.Conv2d(d, d, 3, padding=1, **kw)
                                    for _ in range(num_levels))
        # f32 island: the box-position MLP (Linear, ReLU, LN, Linear, ReLU,
        # LN), LayerNorm eps 1e-6 as in the JAX package
        self.pos_embedd = nn.Sequential(
            nn.Linear(4, 256, device=device), nn.ReLU(),
            nn.LayerNorm(256, eps=1e-6, device=device),
            nn.Linear(256, 1024, device=device), nn.ReLU(),
            nn.LayerNorm(1024, eps=1e-6, device=device))
        self.flatten_linear = nn.Linear(d * roi_out * roi_out, 1024, **kw)
        self.updims = nn.Linear(1024, out_dims, **kw)


class RegionEncoder(nn.Module):
    """(B, R, 4) normalized cxcywh boxes -> (B, R, out_dims) region tokens."""

    def __init__(self, embed_dims: int = 1024, out_dims: int = 4096,
                 num_levels: int = 3, image_size: int = 448,
                 roi_out: int = 14, num_fuse: int = 5, gn_groups: int = 64,
                 device=None, dtype=None):
        super().__init__()
        self.image_size = image_size
        self.roi_out = roi_out
        self.num_levels = num_levels
        self.mlvl_fuse = MLVLFuse(embed_dims, num_levels, num_fuse,
                                  gn_groups, device, dtype)
        self.roi_align = _RoIHead(embed_dims, out_dims, roi_out, num_levels,
                                  device, dtype)

    def forward(self, mlvl_feats, boxes):
        """mlvl_feats: ``num_levels`` (B, L, C) token maps, finest last."""
        ra = self.roi_align
        cdtype = ra.flatten_linear.weight.dtype
        b, r, _ = boxes.shape
        nl = self.num_levels
        feats2d = []
        for f in mlvl_feats:
            bb, l, c = f.shape
            g = int(round(l ** 0.5))
            feats2d.append(f.reshape(bb, g, g, c).permute(0, 3, 1, 2))
        base = feats2d[0].shape[-1]
        to_shape = [(base * 2 ** lvl,) * 2 for lvl in range(nl)][::-1]
        feats2d = [resize_bilinear_align_corners(f, s, cdtype)
                   for f, s in zip(feats2d, to_shape)]
        fused = self.mlvl_fuse(feats2d)

        pos = ra.pos_embedd(boxes.to(torch.float32))            # (B, R, 1024)
        rois = (boxes * self.image_size).to(torch.float32)      # the quirk
        acc = 0.0
        for lvl in range(nl):
            pooled = roi_align_batched(
                fused[lvl].permute(0, 2, 3, 1), rois,
                output_size=self.roi_out,
                spatial_scale=1.0 / ROI_STRIDES[lvl], sampling_ratio=2,
                aligned=True)
            pooled = pooled.reshape(b * r, self.roi_out, self.roi_out, -1)
            acc = acc + ra.pconvs[lvl](
                pooled.permute(0, 3, 1, 2).to(cdtype)).to(torch.float32)
        acc = torch.relu(acc.to(cdtype))                 # (B*R, C, out, out)
        tokens = ra.flatten_linear(acc.reshape(b * r, -1))
        tokens = tokens.reshape(b, r, 1024) + pos.to(cdtype)
        return ra.updims(tokens)
