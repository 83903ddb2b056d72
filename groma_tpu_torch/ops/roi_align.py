"""RoIAlign as two interpolation matmuls (counterpart of
``roi_align_batched`` in ``groma_tpu/ops/roi_align.py``).

Bilinear sampling is separable, so the pooled map of one roi is
``W_y @ feat @ W_x^T`` with dense per-roi interpolation matrices that
carry mmcv's boundary rules (samples outside [-1, size] contribute 0,
in-range samples clamp to the edge) and average the ``sampling_ratio``^2
taps of each bin.  fp32 throughout; ``roi_chunk`` bounds peak memory.
"""

from __future__ import annotations

import torch


def _axis_weights(start, bin_size, size: int, out: int, g: int):
    """(R,) roi start + bin size along one axis -> (R, out, size) weights."""
    dev = start.device
    ph = torch.arange(out, dtype=torch.float32, device=dev)[:, None]
    ig = torch.arange(g, dtype=torch.float32, device=dev)[None, :]
    p = start[:, None, None] + (ph + (ig + 0.5) / g) * bin_size[:, None, None]
    ok = ((p >= -1.0) & (p <= size)).to(torch.float32)
    c = p.clamp(0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w = (1.0 - (c[..., None] - grid).abs()).clamp(min=0.0)   # tent kernel
    return (w * ok[..., None]).mean(dim=2)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor,
                      output_size: int = 14, spatial_scale: float = 1.0,
                      sampling_ratio: int = 2, aligned: bool = True,
                      roi_chunk: int = 25) -> torch.Tensor:
    """features (B, H, W, C), boxes (B, R, 4) xyxy in input pixels ->
    (B, R, output_size, output_size, C) f32."""
    b, h, w, c = features.shape
    r = boxes.shape[1]
    out = output_size
    features = features.to(torch.float32)
    boxes = boxes.to(torch.float32)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[..., 0] * spatial_scale - offset
    y1 = boxes[..., 1] * spatial_scale - offset
    roi_w = boxes[..., 2] * spatial_scale - offset - x1
    roi_h = boxes[..., 3] * spatial_scale - offset - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    pooled = torch.empty((b, r, out, out, c), dtype=torch.float32,
                         device=features.device)
    for i in range(b):
        for j in range(0, r, roi_chunk):
            sl = slice(j, min(r, j + roi_chunk))
            wy = _axis_weights(y1[i, sl], roi_h[i, sl] / out, h, out,
                               sampling_ratio)
            wx = _axis_weights(x1[i, sl], roi_w[i, sl] / out, w, out,
                               sampling_ratio)
            t = torch.einsum('roh,hwc->rowc', wy, features[i])
            pooled[i, sl] = torch.einsum('rowc,rpw->ropc', t, wx)
    return pooled
