"""Multi-scale deformable attention, dense form (counterpart of
``ms_deform_attn_dense`` and ``sampling_locations_from_reference`` in
``groma_tpu/ops/msda.py``).

grid_sample's bilinear weight of a sample at (x, y) on cell (cy, cx) is
``relu(1-|y-cy|) * relu(1-|x-cx|)`` (zero padding included), so with the
attention weights folded in, each (query, head) row is a dense matrix over
the feature grid and the output is one matmul against the value grid.
Groma's 32x32 grid takes this branch; the gather form for grids above
64x64 is not ported.
"""

from __future__ import annotations

import torch

DENSE_MAX_CELLS = 64 * 64


def ms_deform_attn_dense(value: torch.Tensor, spatial_shapes: tuple,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, nh, d), S = sum H_l * W_l; sampling_locations
    (B, Q, nh, L, P, 2) normalized (x, y); attention_weights
    (B, Q, nh, L, P) -> (B, Q, nh * d)."""
    b, s, nh, d = value.shape
    _, q, _, nl, _, _ = sampling_locations.shape
    if nl != len(spatial_shapes):
        raise ValueError('one spatial shape per level')
    if max(h * w for h, w in spatial_shapes) > DENSE_MAX_CELLS:
        raise ValueError('grids above 64x64 need the gather form of MSDA, '
                         'which is not ported yet')
    orig_dtype = value.dtype
    value = value.to(torch.float32)
    loc = sampling_locations.to(torch.float32)
    attn = attention_weights.to(torch.float32)
    dev = value.device

    out = torch.zeros((b, q, nh, d), dtype=torch.float32, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        vl = value[:, start:start + h * w].reshape(b, h, w, nh, d)
        start += h * w
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                    # (B,Q,nh,P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        tx = (1.0 - (x[..., None] - gx).abs()).clamp(min=0.0)
        ty = (1.0 - (y[..., None] - gy).abs()).clamp(min=0.0)
        ty = ty * attn[:, :, :, lvl, :, None]
        wd = torch.einsum('bqhpy,bqhpx->bhqyx', ty, tx)
        out = out + torch.einsum('bhqyx,byxhd->bqhd', wd, vl)
    return out.reshape(b, q, nh * d).to(orig_dtype)


def sampling_locations_from_reference(reference_points: torch.Tensor,
                                      offsets: torch.Tensor,
                                      spatial_shapes: tuple,
                                      num_points: int) -> torch.Tensor:
    """reference_points (B, Q, L, 2 or 4) normalized, offsets
    (B, Q, nh, L, P, 2) -> sampling locations (B, Q, nh, L, P, 2)."""
    if reference_points.shape[-1] == 2:
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=offsets.dtype, device=offsets.device)
        return (reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :])
    if reference_points.shape[-1] == 4:
        return (reference_points[:, :, None, :, None, :2]
                + offsets / num_points
                * reference_points[:, :, None, :, None, 2:] * 0.5)
    raise ValueError('reference_points last dim must be 2 or 4')
