"""Multi-scale deformable attention (counterpart of ``groma_tpu/ops/msda.py``:
``ms_deform_attn``, ``ms_deform_attn_dense`` and
``sampling_locations_from_reference``).

Both forms compute grid_sample with ``align_corners=False`` and zero
padding (pixel = loc * size - 0.5; corners off the map contribute 0):
- dense: the bilinear weight of a sample at (x, y) on cell (cy, cx) is
  ``relu(1-|y-cy|) * relu(1-|x-cx|)``, so with the attention weights folded
  in each (query, head) row is a dense matrix over the grid and the output
  is one matmul against the value grid.  Groma's 32x32 grid takes it.
- gather: the four corners of each sample read by advanced indexing, for
  grids above 64x64 cells (``msda``, as ``groma_tpu/models/ddetr.py``
  dispatches).
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


def ms_deform_attn(value: torch.Tensor, spatial_shapes: tuple,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The gather form: shapes as ``ms_deform_attn_dense``."""
    b, s, nh, d = value.shape
    _, q, _, nl, np_, _ = sampling_locations.shape
    if nl != len(spatial_shapes):
        raise ValueError('one spatial shape per level')
    orig_dtype = value.dtype
    value = value.to(torch.float32)
    sampling_locations = sampling_locations.to(torch.float32)
    attention_weights = attention_weights.to(torch.float32)
    dev = value.device
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    hidx = torch.arange(nh, device=dev)[None, None, :, None]

    out = torch.zeros((b, q, nh, d), dtype=torch.float32, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        vl = value[:, start:start + h * w].reshape(b, h, w, nh, d)
        start += h * w
        loc = sampling_locations[:, :, :, lvl]                # (B,Q,nh,P,2)
        wt = attention_weights[:, :, :, lvl]                  # (B,Q,nh,P)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        lx, ly = x - x0, y - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

        def corner(yi, xi, cw):
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = vl[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1), hidx]
            return v * (cw * ok.to(torch.float32))[..., None]

        sampled = (corner(y0i, x0i, (1 - ly) * (1 - lx))
                   + corner(y0i, x0i + 1, (1 - ly) * lx)
                   + corner(y0i + 1, x0i, ly * (1 - lx))
                   + corner(y0i + 1, x0i + 1, ly * lx))
        out = out + (sampled * wt[..., None]).sum(dim=3)
    return out.reshape(b, q, nh * d).to(orig_dtype)


def uses_dense_form(spatial_shapes: tuple) -> bool:
    """The dense form up to 64x64 cells a level, the gather form above."""
    return max(h * w for h, w in spatial_shapes) <= DENSE_MAX_CELLS


def msda(value: torch.Tensor, spatial_shapes: tuple,
         sampling_locations: torch.Tensor,
         attention_weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention by the form ``uses_dense_form`` picks."""
    form = ms_deform_attn_dense if uses_dense_form(spatial_shapes) \
        else ms_deform_attn
    return form(value, spatial_shapes, sampling_locations, attention_weights)


def sampling_locations_from_reference(reference_points: torch.Tensor,
                                      offsets: torch.Tensor,
                                      spatial_shapes: tuple,
                                      num_points: int) -> torch.Tensor:
    """reference_points (B, Q, L, 2 or 4) normalized, offsets
    (B, Q, nh, L, P, 2) -> sampling locations (B, Q, nh, L, P, 2)."""
    if reference_points.shape[-1] == 2:
        # filled on the device (a captured prefill copies no host data)
        normalizer = offsets.new_empty((len(spatial_shapes), 2))
        for lvl, (h, w) in enumerate(spatial_shapes):
            normalizer[lvl, 0].fill_(w)
            normalizer[lvl, 1].fill_(h)
        return (reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :])
    if reference_points.shape[-1] == 4:
        return (reference_points[:, :, None, :, None, :2]
                + offsets / num_points
                * reference_points[:, :, None, :, None, 2:] * 0.5)
    raise ValueError('reference_points last dim must be 2 or 4')
