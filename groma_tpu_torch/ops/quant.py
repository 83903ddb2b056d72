"""Weight-only int8 quantization and the int8 matmul.

Counterpart of ``groma_tpu/ops/quant.py``.  ``int8_matmul`` replaces the
TPU kernel ``_int8_matmul_kernel`` and, from ``DENSE_MIN_ROWS`` rows on,
the XLA route of the same entry, with the hand-written CUDA kernel in
``csrc/int8_matmul.cu``, two tiles that round as the two JAX routes do:
for decode (M < 256) a tile that streams the weights through a TMA ring
into ``mma.sync`` with the batch as N and scales the finished dot, split
over K by ``decode_plan``; for prefill a tile on ``wgmma`` that
dequantizes each weight to bf16 in registers, as ``dequantize_weight``
rounds it, on a persistent grid that ``prefill_plan`` sizes (its tiles:
``prefill_tiles``).

* ``int8_matmul_reference`` is the decode tile's plain version, callable
  on any device: f32 dot of x against the int8 weights, then the
  per-column scale, in x's own dtype (the TPU kernel in interpret mode does
  not cast x to bf16 either).
* ``int8_matmul_dense_reference`` is the prefill tile's: the f32 product
  of x in bf16 and the bf16-dequantized weights, rounded to bf16 (JAX's
  route at M >= 256).
* ``int8_matmul`` takes ``int8_matmul_reference`` for every tensor on the
  CPU, at every M, as JAX in interpret mode runs the kernel body.  On a
  CUDA tensor it launches a tile or raises.  ``int8_matmul.launches``
  counts launches, one per call, and ``int8_matmul.prefill_launches``
  those of the prefill tile.
"""

from __future__ import annotations

import torch

DENSE_MIN_ROWS = 256      # from this many rows on, the prefill tile


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as an IEEE division on every device.  PyTorch's CUDA
    kernel multiplies by the reciprocal when the divisor is a Python
    scalar, which can move a quantized value across a rounding tie.  The
    divisor is filled on x's device, not copied from the host, so a
    captured CUDA graph may hold the division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_weight(w: torch.Tensor, pad_to: int = 0):
    """(K, N) float -> (int8 (K, N'), scale (N',) f32), symmetric
    per-column; ``pad_to`` zero-pads N up to a multiple (scale 1.0).
    The result is row-major, as the kernel reads it, whatever w's strides."""
    w = w.to(torch.float32).contiguous()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, true_div(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    if pad_to:
        pad = (-q.shape[1]) % pad_to
        if pad:
            q = torch.nn.functional.pad(q, (0, pad))
            scale = torch.nn.functional.pad(scale, (0, pad), value=1.0)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ int8 (K, N) * scale (N,): f32 dot, scale after the dot,
    result in x.dtype."""
    acc = x.to(torch.float32) @ w_q.to(torch.float32)
    return (acc * scale.to(torch.float32)).to(x.dtype)


def int8_matmul_dense_reference(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) in bf16 @ bf16(int8 (K, N) * scale (N,)): the f32 product
    with the weights dequantized first, rounded to bf16 (the prefill
    tile's arithmetic, and JAX's route from 256 rows on)."""
    w = dequantize_weight(w_q, scale).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w).to(torch.bfloat16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


DECODE_TILE = (128, 128)    # k rows, columns of one weight box
DECODE_ROWS = 8             # rows of x a decode CTA takes: mma.sync's N
DECODE_CTAS_PER_SM = 2      # the decode tile's occupancy (shared memory)
_K_MULTIPLE, _N_MULTIPLE = 8, 16   # the tensor maps' 16-byte row pitches


def decode_plan(m: int, k: int, n: int, sms: int) -> tuple:
    """(split_rows, splits) of the decode tile for x (M < 256, K) @ (K, N)
    on a card with ``sms`` SMs: K cut into ``splits`` ranges of
    ``split_rows`` (whole 128-row boxes, the last one shorter and not
    empty), taken by every (128-column tile, 8-row chunk of x).  Those
    blocks times the splits fill at most one wave of
    ``DECODE_CTAS_PER_SM`` CTAs per SM, with equal ranges, but at least
    one CTA per SM where the shape has that many tiles."""
    rows, cols = DECODE_TILE
    tiles = _cdiv(k, rows)
    blocks = _cdiv(n, cols) * _cdiv(m, DECODE_ROWS)
    splits = min(tiles, max(1, DECODE_CTAS_PER_SM * sms // blocks))
    per = _cdiv(tiles, splits)
    while per > 1 and blocks * _cdiv(tiles, per) < sms:
        per -= 1
    return per * rows, _cdiv(tiles, per)


PREFILL_TILE = (256, 128)   # tokens, weight columns of one output tile
PREFILL_STAGE_ROWS = 64     # k rows of one stage of the prefill ring


def prefill_plan(m: int, n: int, sms: int) -> tuple:
    """(ctas, token_tiles, column_tiles) of the prefill tile for x (M, K) @
    (K, N): one persistent CTA per SM (its shared memory and registers
    hold one), at most one per output tile."""
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


# (device, stream) -> (f32 split-K workspace, int32 arrival counters)
_buffers = {}


def _decode_buffers(device, partial: int, counters: int) -> tuple:
    """The decode tile's split-K workspace (``partial`` floats) and arrival
    counters (one per block) of the current stream of ``device``: the
    counters are zeroed once and left at zero by every launch (the last
    CTA of each block resets its own), so calls in stream order, and a CUDA
    graph replaying them, share one pair; calls on two streams, which may
    overlap, never do."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws, cnt = _buffers.get(key, (None, None))
    if ws is None or ws.numel() < partial:
        ws = torch.empty(max(partial, 1 << 20), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 256), dtype=torch.int32,
                          device=device)
    _buffers[key] = ws, cnt
    return ws, cnt


def _launch(x, w_q, scale):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    partial = counters = None
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if m >= DENSE_MIN_ROWS:
        split_rows, splits = 0, prefill_plan(m, n, sms)[0]
    else:
        split_rows, splits = decode_plan(m, k, n, sms)
        if splits > 1:
            partial, counters = _decode_buffers(
                x.device, splits * m * n,
                _cdiv(n, DECODE_TILE[1]) * _cdiv(m, DECODE_ROWS))
    status = library().groma_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None,
        m, k, n, split_rows, splits, stream_ptr(x))
    check(status, 'int8_matmul')
    int8_matmul.launches += 1
    if split_rows == 0:
        int8_matmul.prefill_launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ int8 weights (K, N) with per-column scales -> (M, N).

    CPU tensors: the plain version.  CUDA tensors: x bf16, w_q int8, scale
    f32 (N,), all contiguous, x and w_q 16-byte aligned; the decode tile
    for M < 256 (the scale after the dot), the prefill tile from 256 rows
    on (the weights dequantized to bf16 first), the result in bf16.  K not
    a multiple of 8 or N not of 16 is zero-padded per call (copies of x
    and the weights), as JAX's wrapper pads."""
    if x.device.type == 'cpu':
        return int8_matmul_reference(x, w_q, scale)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_matmul: unsupported device {x.device}')
    m, k = x.shape
    if (w_q.dim() != 2 or w_q.shape[0] != k or m < 1
            or scale.shape != (w_q.shape[1],)):
        raise ValueError(f'int8_matmul: shapes x {tuple(x.shape)}, '
                         f'w {tuple(w_q.shape)}, scale {tuple(scale.shape)}')
    if (x.dtype, w_q.dtype, scale.dtype) != (torch.bfloat16, torch.int8,
                                             torch.float32):
        raise ValueError(f'int8_matmul: dtypes {x.dtype}, {w_q.dtype}, '
                         f'{scale.dtype}; the kernel takes bf16, int8, f32')
    if not (w_q.device == scale.device == x.device):
        raise ValueError('int8_matmul: tensors on different devices')
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()) or x.data_ptr() % 16 \
            or w_q.data_ptr() % 16:
        raise ValueError('int8_matmul: the kernel takes contiguous tensors '
                         'with 16-byte-aligned x and weights')
    n = w_q.shape[1]
    pad_k, pad_n = (-k) % _K_MULTIPLE, (-n) % _N_MULTIPLE
    if pad_k or pad_n:
        x = torch.nn.functional.pad(x, (0, pad_k))
        w_q = torch.nn.functional.pad(w_q, (0, pad_n, 0, pad_k))
        scale = torch.nn.functional.pad(scale, (0, pad_n))
        return _launch(x, w_q, scale)[:, :n]
    return _launch(x, w_q, scale)


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0
