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
Parameters may be kept in f32 while the convs and linears compute in
``compute_dtype`` (a trainer's master weights).
``quant=True`` (``GromaConfig.vision_int8``) runs the fuse convs and the
RoI head's conv with both operands int8 (``ops.quant.w8a8_conv``), from
the same float parameters, with JAX's scales: each fuse conv quantizes its
three input pieces (kept channels, from the coarser level, from the finer
one) apart, each with its own activation scale and the per-output-channel
scales of its kernel slice, and sums the f32 results; the RoI head
quantizes the three pooled levels as one concatenation against the
concatenated kernels, then adds the summed biases.  The float path
concatenates the pieces and sums three per-level convs instead, which is
the same function.
Left out: the sharding constraints.
Convolutions run channels-first (torch's layout); RoIAlign takes the JAX
package's channels-last layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.models.layers import linear
from groma_tpu_torch.ops.quant import w8a8_conv
from groma_tpu_torch.ops.roi_align import roi_align_batched

ROI_STRIDES = (14 / 8, 14 / 4, 14 / 2)


def conv2d(m: nn.Conv2d, x):
    """``m(x)`` with the weight and bias cast to x's dtype."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding)


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

    def forward(self, x, quant: bool = False):
        """x: a (B, C, H, W) map, or the list of its channel pieces, which
        ``quant`` quantizes apart (each against its kernel slice)."""
        if quant:
            dt = x[0].dtype
            acc, off = None, 0
            for piece in x:
                c = piece.shape[1]
                y = w8a8_conv(piece, self.conv.weight[:, off:off + c])
                acc = y if acc is None else acc + y
                off += c
            x = acc.to(dt)
        else:
            dt = x.dtype
            x = conv2d(self.conv, x)
        x = F.group_norm(x.to(torch.float32), self.gn.num_groups,
                         self.gn.weight.to(torch.float32),
                         self.gn.bias.to(torch.float32), self.gn.eps)
        return torch.relu(x).to(dt)


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

    def forward(self, feats, dtype, quant: bool = False):
        """List of (B, C, H, W) maps, largest first -> fused maps in
        ``dtype``; ``quant``: the fuse convs in int8 (``ConvModuleGN``)."""
        withcoord = []
        for conv, f in zip(self.input_conv, feats):
            b, _, h, w = f.shape
            xs = torch.linspace(-1.0, 1.0, w, device=f.device)
            ys = torch.linspace(-1.0, 1.0, h, device=f.device)
            coord = torch.stack([xs[None, :].expand(h, w),
                                 ys[:, None].expand(h, w)], 0)
            coord = coord[None].expand(b, -1, -1, -1).to(dtype)
            withcoord.append(conv2d(conv, torch.cat([f.to(dtype), coord],
                                                    dim=1)))
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
                pieces = [tar[:, :remain], from_top, from_down]
                fused.append(conv(pieces, True) if quant
                             else conv(torch.cat(pieces, dim=1)))
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
                 device=None, dtype=None, compute_dtype=None,
                 quant: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype or dtype or torch.float32
        self.quant = quant
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
        cdtype = self.compute_dtype
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
        fused = self.mlvl_fuse(feats2d, cdtype, self.quant)

        pos = ra.pos_embedd(boxes.to(torch.float32))            # (B, R, 1024)
        rois = (boxes * self.image_size).to(torch.float32)      # the quirk
        pooled_all = []
        for lvl in range(nl):
            pooled = roi_align_batched(
                fused[lvl].permute(0, 2, 3, 1), rois,
                output_size=self.roi_out,
                spatial_scale=1.0 / ROI_STRIDES[lvl], sampling_ratio=2,
                aligned=True)
            pooled_all.append(pooled.reshape(
                b * r, self.roi_out, self.roi_out, -1).permute(
                    0, 3, 1, 2).to(cdtype))
        if self.quant:
            # one int8 conv over the levels' concatenation, then the
            # biases' sum, as JAX computes the pconvs
            acc = w8a8_conv(torch.cat(pooled_all, dim=1),
                            torch.cat([c.weight for c in ra.pconvs], dim=1))
            bias = ra.pconvs[0].bias
            for c in ra.pconvs[1:]:
                bias = bias + c.bias
            acc = acc + bias[:, None, None]
        else:
            acc = 0.0
            for conv, pooled in zip(ra.pconvs, pooled_all):
                acc = acc + conv2d(conv, pooled).to(torch.float32)
        acc = torch.relu(acc.to(cdtype))                 # (B*R, C, out, out)
        tokens = linear(ra.flatten_linear, acc.reshape(b * r, -1))
        tokens = tokens.reshape(b, r, 1024) + pos.to(cdtype)
        return linear(ra.updims, tokens)
