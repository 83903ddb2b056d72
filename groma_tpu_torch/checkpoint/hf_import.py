"""The numpy-side pieces of ``groma_tpu/checkpoint/hf_import.py`` that the
port needs to read a reference-format checkpoint: the file loaders, the
DINOv2 position-table resize and the bitsandbytes-nf4 weight import.

The port's modules carry the reference's parameter names, so a state dict
loads into them as it is; the one transform the JAX package's import
applies on the way in is the bicubic resize of the ViT position table to
the deploy grid, which ``checkpoint.loader.load_groma`` applies itself.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


# ------------------------------------------------------------ file loading

def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a HF checkpoint directory (safetensors preferred, torch .bin
    fallback) into a flat name->numpy dict."""
    tensors = {}
    st_files = sorted(f for f in os.listdir(path)
                      if f.endswith('.safetensors'))
    if st_files:
        from safetensors.numpy import load_file
        for f in st_files:
            tensors.update(load_file(os.path.join(path, f)))
        return tensors
    bin_files = sorted(f for f in os.listdir(path) if f.endswith('.bin'))
    if not bin_files:
        raise FileNotFoundError(f'no safetensors/bin weights under {path}')
    import torch
    for f in bin_files:
        sd = torch.load(os.path.join(path, f), map_location='cpu',
                        weights_only=True)
        tensors.update({k: v.float().numpy() if v.dtype == torch.bfloat16
                        else v.numpy() for k, v in sd.items()})
    return tensors


def load_config_json(path: str) -> dict:
    with open(os.path.join(path, 'config.json')) as f:
        return json.load(f)


# ---------------------------------------------------- torch-bicubic resize

def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Torch's bicubic convolution kernel (a = -0.75)."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = ((a + 2) * t[m1] - (a + 3)) * t[m1] * t[m1] + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = (((t[m2] - 5) * t[m2] + 8) * t[m2] - 4) * a
    return out


def _resize_axis_bicubic(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Separable torch-style bicubic (align_corners=False, border clamp)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    weights = np.zeros((out_size, 4))
    idx = np.zeros((out_size, 4), np.int64)
    for k in range(4):
        ik = i0 - 1 + k
        weights[:, k] = _cubic_kernel(src - ik)
        idx[:, k] = np.clip(ik, 0, in_size - 1)
    x_moved = np.moveaxis(x, axis, 0)
    out = np.einsum('ok,ok...->o...', weights, x_moved[idx])
    return np.moveaxis(out, 0, axis).astype(x.dtype)


def interpolate_pos_embed(pos: np.ndarray, src_grid: int,
                          dst_grid: int) -> np.ndarray:
    """(1, 1+src², C) -> (1, 1+dst², C), CLS slot kept, patch grid resized
    with torch-bicubic numerics (matches HF Dinov2Embeddings
    interpolate_pos_encoding, applied once at import instead of per step)."""
    cls_tok, patch = pos[:, :1], pos[:, 1:]
    c = patch.shape[-1]
    grid = patch.reshape(src_grid, src_grid, c)
    grid = _resize_axis_bicubic(grid, dst_grid, 0)
    grid = _resize_axis_bicubic(grid, dst_grid, 1)
    return np.concatenate(
        [cls_tok, grid.reshape(1, dst_grid * dst_grid, c)], axis=1)


def resize_vit_pos_embed(sd: Dict[str, np.ndarray], key: str,
                         deploy_grid: int) -> Dict[str, np.ndarray]:
    """``sd`` with its DINOv2 position table ``key`` resized to the deploy
    grid, as the JAX package's ``import_dinov2`` does on the way in (a
    table already at that grid is kept as it is)."""
    pos = sd[key]
    src_grid = int(round((pos.shape[1] - 1) ** 0.5))
    if src_grid == deploy_grid:
        return sd
    return {**sd, key: interpolate_pos_embed(pos, src_grid, deploy_grid)}


# --------------------------------------------- bitsandbytes 4-bit import

def is_bnb_nf4(sd: Dict[str, np.ndarray], name: str) -> bool:
    """True when ``name`` was serialized by a bitsandbytes Linear4bit (the
    reference's nf4 switch; bnb 0.43 writes the packed codes as ``<name>``
    beside ``<name>.absmax``, ``<name>.quant_map`` and
    ``<name>.quant_state.bitsandbytes__nf4``)."""
    return f'{name}.quant_state.bitsandbytes__nf4' in sd \
        or (f'{name}.absmax' in sd and f'{name}.quant_map' in sd)


def import_bnb_nf4_weight(sd: Dict[str, np.ndarray], name: str,
                          shape=None, dtype=np.float32) -> np.ndarray:
    """A bnb-nf4 serialized weight, dequantized to a dense array.

    The layout without double quantization: ``<name>`` the packed uint8
    codes (two a byte, the first element in the HIGH nibble),
    ``<name>.absmax`` the f32 block scales, ``<name>.quant_map`` the
    16-entry NF4 table.  ``shape`` ((out_features, in_features)) comes
    from the quant_state blob where it parses, else must be given.  A
    double-quantized absmax raises NotImplementedError.  No loader calls
    it, as in the JAX package."""
    from groma_tpu_torch.ops.quant4 import NF4_TABLE

    if f'{name}.nested_absmax' in sd:
        raise NotImplementedError(
            'double-quantized (bnb_4bit_use_double_quant) checkpoints are '
            'not supported; re-export with double quant off')
    codes = np.asarray(sd[name]).reshape(-1).astype(np.uint8)
    absmax = np.asarray(sd[f'{name}.absmax']).astype(np.float32).reshape(-1)
    qmap = np.asarray(sd.get(f'{name}.quant_map', NF4_TABLE))
    np.testing.assert_allclose(np.sort(qmap.reshape(-1)),
                               np.sort(NF4_TABLE), atol=1e-6,
                               err_msg='quant_map is not the NF4 table')
    if shape is None:
        qs = sd.get(f'{name}.quant_state.bitsandbytes__nf4')
        if qs is None:
            raise ValueError(f'{name}: no shape in state dict; pass shape=')
        shape = tuple(json.loads(bytes(np.asarray(qs).astype(
            np.uint8)))['shape'])
    numel = int(np.prod(shape))
    block = numel // absmax.shape[0]
    idx = np.stack([(codes >> 4) & 0xF, codes & 0xF],
                   axis=1).reshape(-1)[:numel]
    vals = qmap.reshape(-1)[idx].reshape(-1, block) * absmax[:, None]
    return vals.reshape(shape).astype(dtype)
