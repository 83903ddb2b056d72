"""4-bit weight-only quantization, the packed-int4 matmul and the nf4
codec.

Counterpart of ``groma_tpu/ops/quant4.py``.  The nf4 codec
(``nf4_quantize``, ``nf4_dequantize``: bitsandbytes' NormalFloat4 table
with blockwise absmax over the flattened weight) is format parity for
importing bnb-nf4 checkpoints and has no kernel, as in JAX.  ``int4_matmul`` replaces
the TPU kernel ``_int4_matmul_kernel`` with the hand-written CUDA kernel in
``csrc/int4_matmul.cu``, at every M: for decode (M <= ``DECODE_MAX_ROWS``)
a tile that streams the weights through a TMA ring into ``mma.sync`` with
the batch as N, split over K by ``decode_plan``; for prefill a tile on
``wgmma`` with the unpacked weights as the register operand and x from a
TMA ring, on a persistent grid that ``prefill_plan`` sizes (its tiles and
k stages: ``prefill_tiles``, ``prefill_stages``).

Format (the JAX package's, byte for byte): symmetric q in [-7, 7] with a
scale per (``INT4_BLOCK``-row K block, column), stored as q + 8 nibbles;
rows k and k + K/2 share byte k of the (K/2, N) uint8 array, row k in the
low nibble.

* ``int4_matmul_reference`` is the plain PyTorch version, callable on any
  device: the weights dequantized to f32, an f32 dot, the result in x's
  dtype (the JAX wrapper's CPU path).
* ``int4_matmul`` takes the plain version only for tensors on the CPU.  On
  a CUDA tensor it launches the kernel or raises; there is no
  dequantize-plus-matmul route.  ``int4_matmul.launches`` counts launches,
  one per call at every M, and ``int4_matmul.prefill_launches`` those of
  the prefill tile.
"""

from __future__ import annotations

import torch

from groma_tpu_torch.ops.quant import true_div

import numpy as np

# bitsandbytes' NF4 table (create_normal_map order: 0 at index 7)
NF4_TABLE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)

INT4_BLOCK = 256          # scale block of the packed-int4 LLM tree
DECODE_MAX_ROWS = 8       # up to this many rows: the weight-streaming tile
_N_MULTIPLE = 64          # the kernel takes N % 64 == 0


def quantize_weight_int4(w: torch.Tensor, block: int = 128,
                         pad_to: int = 0) -> dict:
    """(K, N) float -> {'q': uint8 (K/2, N'), 'scale': f32 (K/block, N'),
    'block': block}; ``pad_to`` zero-pads N to a multiple first (an
    all-zero column gets scale 1.0)."""
    k, n = w.shape
    if k % 2 or k % block:
        raise ValueError(f'quantize_weight_int4: K={k} is not a multiple of '
                         f'2 and of the block {block}')
    w = w.to(torch.float32)
    if pad_to and n % pad_to:
        w = torch.nn.functional.pad(w, (0, (-n) % pad_to))
        n = w.shape[1]
    amax = w.reshape(k // block, block, n).abs().amax(dim=1)
    scale = torch.where(amax > 0, true_div(amax, 7.0), torch.ones_like(amax))
    q = torch.round(w / scale.repeat_interleave(block, dim=0))
    q = torch.clamp(q, -7, 7).to(torch.int32) + 8          # 1..15
    packed = (q[:k // 2] | (q[k // 2:] << 4)).to(torch.uint8)
    return {'q': packed.contiguous(), 'scale': scale.contiguous(),
            'block': block}


def dequantize_weight_int4(qd: dict, dtype=torch.float32) -> torch.Tensor:
    packed = qd['q'].to(torch.int32)
    q = torch.cat([(packed & 0xF) - 8, (packed >> 4) - 8], dim=0)
    scale = qd['scale'].repeat_interleave(qd['block'], dim=0)
    return (q.to(torch.float32) * scale).to(dtype)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor, block: int = INT4_BLOCK,
                          out_dtype=None) -> torch.Tensor:
    """x (M, K) @ packed int4 (K/2, N) with (K/block, N) scales: the f32
    dot against the dequantized weights, result in x.dtype (or
    ``out_dtype``)."""
    w = dequantize_weight_int4({'q': packed, 'scale': scale, 'block': block})
    return (x.to(torch.float32) @ w).to(out_dtype or x.dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


DECODE_TILE = (64, 128)     # packed rows, columns of one TMA box
DECODE_CTAS_PER_SM = 2      # the decode tile's occupancy (registers)


def decode_plan(k: int, n: int, sms: int) -> tuple:
    """(split_rows, splits) of the decode tile for x (M <= 8, K) @ packed
    (K/2, N) on a card with ``sms`` SMs: the K/2 packed rows cut into
    ``splits`` ranges of ``split_rows`` (whole 64-row tiles, the last one
    shorter and not empty).  The 128-column tiles times the splits fill at
    most one wave of ``DECODE_CTAS_PER_SM`` CTAs per SM, with equal ranges,
    but at least one CTA per SM where the shape has that many tiles.  Each
    64-row tile lies in one scale block of each nibble half, since K/2 is a
    multiple of 128."""
    rows, cols = DECODE_TILE
    tiles = k // 2 // rows
    col_tiles = _cdiv(n, cols)
    splits = min(tiles, max(1, DECODE_CTAS_PER_SM * sms // col_tiles))
    per = _cdiv(tiles, splits)
    while per > 1 and col_tiles * _cdiv(tiles, per) < sms:
        per -= 1
    return per * rows, _cdiv(tiles, per)


PREFILL_TILE = (128, 128)   # tokens, weight columns of one output tile
PREFILL_STAGE_ROWS = 128    # k rows of one stage of the prefill ring


def prefill_plan(m: int, n: int, sms: int) -> tuple:
    """(ctas, token_tiles, column_tiles) of the prefill tile for x (M, K) @
    packed (K/2, N): one persistent CTA per SM (its shared memory and
    registers hold one), at most one per output tile."""
    tok_tiles = _cdiv(m, PREFILL_TILE[0])
    col_tiles = _cdiv(n, PREFILL_TILE[1])
    return min(sms, tok_tiles * col_tiles), tok_tiles, col_tiles


def prefill_tiles(m: int, n: int, sms: int) -> list:
    """The output tiles of each CTA of the prefill grid in the kernel's
    order, as (token tile, column tile): CTA c takes tiles c, c + ctas, ...,
    and tile i is column tile i // token_tiles, token tile i % token_tiles,
    so the CTAs in flight share few column tiles."""
    ctas, tok_tiles, col_tiles = prefill_plan(m, n, sms)
    return [[(i % tok_tiles, i // tok_tiles)
             for i in range(c, tok_tiles * col_tiles, ctas)]
            for c in range(ctas)]


def prefill_stages(k: int) -> list:
    """The k stages of one prefill output tile in the kernel's order, as
    (k0, packed row, nibble half, scale block, fold): the low half's rows k
    < K/2 first (low nibbles of packed rows k), then the high half's (high
    nibbles of packed rows k - K/2); a stage's block dot is folded into the
    output with the block's scale where the block or the half ends."""
    kh, rows = k // 2, PREFILL_STAGE_ROWS
    out = []
    for k0 in range(0, k, rows):
        end = k0 + rows
        out.append((k0, k0 % kh, int(k0 >= kh), k0 // INT4_BLOCK,
                    end % INT4_BLOCK == 0 or end == kh))
    return out


# (device, stream) -> int32 arrival counters, one per column tile
_counters = {}


def _tile_counters(device, col_tiles: int) -> torch.Tensor:
    """The split-K arrival counters of the current stream of ``device``:
    zeroed once, and left at zero by every launch (its last CTA of each
    column tile resets its own), so calls in stream order, and a CUDA graph
    replaying them, share one buffer; calls on two streams, which may
    overlap, never do."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < col_tiles:
        buf = torch.zeros(max(col_tiles, 256), dtype=torch.int32,
                          device=device)
        _counters[key] = buf
    return buf


def _launch(x, packed, scale, out_dtype):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    partial = counters = None
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if m > DECODE_MAX_ROWS:
        split_rows, splits = 0, prefill_plan(m, n, sms)[0]
    else:
        split_rows, splits = decode_plan(k, n, sms)
        if splits > 1:
            partial = torch.empty((splits, m, n), dtype=torch.float32,
                                  device=x.device)
            counters = _tile_counters(x.device, _cdiv(n, DECODE_TILE[1]))
    status = library().groma_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None,
        m, k, n, split_rows, splits, int(out_dtype == torch.float32),
        stream_ptr(x))
    check(status, 'int4_matmul')
    int4_matmul.launches += 1
    if split_rows == 0:
        int4_matmul.prefill_launches += 1
    if out_dtype == torch.float32:
        int4_matmul.f32_launches += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                block: int = INT4_BLOCK, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ packed int4 weights (K/2, N), per-(block, column) scales
    -> (M, N).

    CPU tensors: the plain version, in x's dtype or ``out_dtype``.  CUDA
    tensors: x bf16, packed uint8, scale f32, all contiguous, block 256, K
    a multiple of 256 and N of 64; the hand-written kernel at every M, the
    result in bf16, or with ``out_dtype=torch.float32`` the f32 it rounds
    to bf16 otherwise (a row-parallel product's partial sum;
    ``int4_matmul.f32_launches`` counts them)."""
    if x.device.type == 'cpu':
        return int4_matmul_reference(x, packed, scale, block, out_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'int4_matmul: unsupported device {x.device}')
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'int4_matmul: out_dtype {out_dtype}; the kernel '
                         f'writes bf16 or f32')
    m, k = x.shape
    n = packed.shape[1] if packed.dim() == 2 else -1
    if (packed.dim() != 2 or packed.shape[0] * 2 != k or block != INT4_BLOCK
            or k % INT4_BLOCK or n % _N_MULTIPLE or m < 1
            or scale.shape != (k // block, n)):
        raise ValueError(f'int4_matmul: shapes x {tuple(x.shape)}, packed '
                         f'{tuple(packed.shape)}, scale {tuple(scale.shape)}, '
                         f'block {block}; the kernel takes block '
                         f'{INT4_BLOCK}, K % {INT4_BLOCK} == 0, N % 64 == 0')
    if (x.dtype, packed.dtype, scale.dtype) != (torch.bfloat16, torch.uint8,
                                                torch.float32):
        raise ValueError(f'int4_matmul: dtypes {x.dtype}, {packed.dtype}, '
                         f'{scale.dtype}; the kernel takes bf16, uint8, f32')
    if not (packed.device == scale.device == x.device):
        raise ValueError('int4_matmul: tensors on different devices')
    if not (x.is_contiguous() and packed.is_contiguous()
            and scale.is_contiguous()) or packed.data_ptr() % 16 \
            or x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError('int4_matmul: the kernel takes contiguous tensors '
                         'with 16-byte-aligned x, weights and scales')
    return _launch(x, packed, scale, out_dtype)


int4_matmul.launches = 0
int4_matmul.prefill_launches = 0
int4_matmul.f32_launches = 0


# -------------------------------------------------------------------- nf4

def nf4_quantize(w: torch.Tensor, block: int = 64) -> dict:
    """bitsandbytes-style NF4: the weight flattened, an absmax per
    ``block`` values, each value the nearest table code (the first on a
    tie), two codes a byte with the first in the HIGH nibble.  Returns
    {'codes': uint8 (numel/2,), 'absmax': f32 (numel/block,), 'shape',
    'block'}."""
    flat = w.to(torch.float32).reshape(-1)
    if flat.numel() % block or flat.numel() % 2:
        raise ValueError(f'nf4_quantize: {flat.numel()} values do not fill '
                         f'blocks of {block} and byte pairs')
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    normed = blocks / torch.where(absmax > 0, absmax,
                                  torch.ones_like(absmax))[:, None]
    table = torch.as_tensor(NF4_TABLE, device=w.device)
    idx = (normed.reshape(-1)[:, None] - table[None]).abs().argmin(1)
    idx = idx.to(torch.uint8)
    codes = idx[1::2] | (idx[0::2] << 4)
    return {'codes': codes, 'absmax': absmax, 'shape': tuple(w.shape),
            'block': block}


def nf4_dequantize(qd: dict, dtype=torch.float32) -> torch.Tensor:
    codes = qd['codes'].to(torch.int64)
    idx = torch.stack([(codes >> 4) & 0xF, codes & 0xF], dim=1).reshape(-1)
    table = torch.as_tensor(NF4_TABLE, device=codes.device)
    vals = table[idx].reshape(-1, qd['block']) * qd['absmax'][:, None]
    return vals.reshape(qd['shape']).to(dtype)
