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

W8A8, the counterpart of JAX's ``quantize_act``, ``w8a8_matmul`` and
``w8a8_conv``: JAX runs them as plain XLA integer dots, not in a TPU
kernel, so on the card the int8 x int8 -> int32 product is one library
call, ``torch._int_mm`` (cuBLASLt), and the quantize and rescale passes
are plain PyTorch.  The products are exact (|acc| <= 11008 x 127^2 <
2^31), so the card's result is bit for bit the plain version's:

* ``int_product`` is the plain exact product, an int32 ``torch.matmul``
  on the CPU; elsewhere (CUDA has no int32 matmul) a float64 one, exact
  because every partial sum is an integer below 2^53;
* ``w8a8_matmul_reference`` / ``w8a8_conv_reference`` are the plain
  versions (the conv's im2col by ``F.unfold``);
* ``w8a8_matmul`` / ``w8a8_conv`` take the plain version for CPU tensors
  and ``torch._int_mm`` for CUDA tensors, raising where its shape rules
  fail (M <= 16, K or N not a multiple of 8); they never fall back to the
  weight-only route.  ``w8a8_conv`` gathers its 3x3 taps into one int8
  im2col matrix (nine shifted products summed in int32 were slower on an
  H100, PERF.md §6).
  ``<wrapper>.launches`` counts their ``torch._int_mm`` calls.
* ``_int_mm``'s fast int8 path on an H100 wants the second operand
  K-major: on the stored row-major (K, N) weights it ran 6.6 x slower
  (PERF.md §6), so the owner of a W8A8 prefill keeps a K-major copy of
  each layer weight (``w8a8_weight``), and the conv's kernel, quantized
  each call anyway, is made K-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
                          scale: torch.Tensor,
                          out_dtype=None) -> torch.Tensor:
    """x (M, K) @ int8 (K, N) * scale (N,): f32 dot, scale after the dot,
    result in x.dtype (or ``out_dtype``)."""
    acc = x.to(torch.float32) @ w_q.to(torch.float32)
    return (acc * scale.to(torch.float32)).to(out_dtype or x.dtype)


def int8_matmul_dense_reference(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor,
                                out_dtype=None) -> torch.Tensor:
    """x (M, K) in bf16 @ bf16(int8 (K, N) * scale (N,)): the f32 product
    with the weights dequantized first, rounded to bf16 (the prefill
    tile's arithmetic, and JAX's route from 256 rows on), or kept in
    ``out_dtype``."""
    w = dequantize_weight(w_q, scale).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w).to(
        out_dtype or torch.bfloat16)


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


def _launch(x, w_q, scale, out_dtype):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
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
        m, k, n, split_rows, splits, int(out_dtype == torch.float32),
        stream_ptr(x))
    check(status, 'int8_matmul')
    int8_matmul.launches += 1
    if split_rows == 0:
        int8_matmul.prefill_launches += 1
    if out_dtype == torch.float32:
        int8_matmul.f32_launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ int8 weights (K, N) with per-column scales -> (M, N).

    CPU tensors: the plain version, in x's dtype or ``out_dtype``.  CUDA
    tensors: x bf16, w_q int8, scale f32 (N,), all contiguous, x and w_q
    16-byte aligned; the decode tile for M < 256 (the scale after the dot),
    the prefill tile from 256 rows on (the weights dequantized to bf16
    first), the result in bf16, or with ``out_dtype=torch.float32`` the
    f32 each tile rounds to bf16 otherwise (a row-parallel product's
    partial sum; ``int8_matmul.f32_launches`` counts them).  K not a
    multiple of 8 or N not of 16 is zero-padded per call (copies of x and
    the weights), as JAX's wrapper pads."""
    if x.device.type == 'cpu':
        return int8_matmul_reference(x, w_q, scale, out_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_matmul: unsupported device {x.device}')
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'int8_matmul: out_dtype {out_dtype}; the kernel '
                         f'writes bf16 or f32')
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
        return _launch(x, w_q, scale, out_dtype)[:, :n]
    return _launch(x, w_q, scale, out_dtype)


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0
int8_matmul.f32_launches = 0


# ------------------------------------------------------------------ W8A8

def _absmax_scale(a: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 scale of an absmax: a / 127 where a > 0, else 1."""
    return torch.where(a > 0, true_div(a, 127.0), torch.ones_like(a))


def _absmax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """max |x| in f32 (over ``dim``, or the whole tensor) in one read:
    exact, from the min and the max."""
    lo, hi = torch.aminmax(x) if dim is None else torch.aminmax(x, dim=dim)
    return torch.maximum(-lo, hi).to(torch.float32)


def _to_int8(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8, the division in f32 (x is
    promoted inside the division, exactly)."""
    return torch.round(x / s).clamp_(-127, 127).to(torch.int8)


def quantize_act(x: torch.Tensor):
    """(M, K) float -> (int8 (M, K), scale (M,) f32), symmetric per-row
    absmax: the activation half of W8A8."""
    s = _absmax_scale(_absmax(x, -1))
    return _to_int8(x, s[:, None]), s


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of two int8 (or int-valued) matrices: an
    int32 ``torch.matmul`` on the CPU, a float64 one elsewhere (exact for
    sums below 2^53)."""
    if a.device.type == 'cpu':
        return a.to(torch.int32) @ b.to(torch.int32)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _rescale_rows(acc, xs, scale, dtype):
    """JAX's order, (acc * xs[:, None]) * scale[None, :] in f32, cast to
    ``dtype``: the int32 sums promoted inside the first product, the cast
    fused into the second."""
    y = torch.mul(acc, xs[:, None])
    if dtype == torch.float32:
        return y.mul_(scale)
    return torch.mul(y, scale, out=torch.empty(y.shape, dtype=dtype,
                                               device=y.device))


def w8a8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ int8 (K, N) with per-column scales: the rows of x
    quantized to int8, the exact int32 product, rescaled in f32 and cast to
    x's dtype."""
    xq, xs = quantize_act(x)
    return _rescale_rows(int_product(xq, w_q), xs, scale, x.dtype)


def _int_mm_shapes(name, m, k, n):
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f'{name}: torch._int_mm takes M > 16 and K, N '
                         f'multiples of 8, not M={m}, K={k}, N={n}')


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ int8 weights (K, N) with per-column scales, both
    operands int8 (dynamic per-row activation quantization) -> (M, N) in
    x's dtype.  CPU tensors: the plain version; CUDA tensors:
    ``torch._int_mm``, which is fastest with K-major weights: pass the
    transpose of an (N, K) copy (``w8a8_weight``) rather than the stored
    row-major (K, N) tensor."""
    if x.device.type == 'cpu':
        return w8a8_matmul_reference(x, w_q, scale)
    if x.device.type != 'cuda':
        raise ValueError(f'w8a8_matmul: unsupported device {x.device}')
    m, k = x.shape
    if w_q.dtype != torch.int8 or w_q.shape[0] != k \
            or scale.shape != (w_q.shape[1],):
        raise ValueError(f'w8a8_matmul: x {tuple(x.shape)}, w '
                         f'{tuple(w_q.shape)} {w_q.dtype}, scale '
                         f'{tuple(scale.shape)}')
    _int_mm_shapes('w8a8_matmul', m, k, w_q.shape[1])
    xq, xs = quantize_act(x)
    acc = torch._int_mm(xq, w_q)
    w8a8_matmul.launches += 1
    return _rescale_rows(acc, xs, scale, x.dtype)


w8a8_matmul.launches = 0


def w8a8_weight(w_q: torch.Tensor) -> torch.Tensor:
    """int8 weights (K, N) -> the same weights as the (K, N) transpose of a
    K-major (N, K) copy, the layout in which ``torch._int_mm`` runs its
    fast int8 path (a new tensor of the weights' size)."""
    return w_q.T.contiguous().T


def quantize_conv_kernel(weight: torch.Tensor):
    """(co, ci, kh, kw) float -> (int8 of the same shape, (co,) f32 scale),
    symmetric per output channel, from the float storage (JAX quantizes
    its (kh, kw, ci, co) kernel the same way, each call)."""
    wf = weight.to(torch.float32)
    ks = _absmax_scale(wf.abs().amax(dim=(1, 2, 3)))
    return _to_int8(wf, ks[:, None, None, None]), ks


def quantize_tensor(x: torch.Tensor):
    """Any float tensor -> (int8, 0-d f32 scale), one symmetric absmax
    scale over the whole tensor (the batch included, as in JAX)."""
    xs = _absmax_scale(_absmax(x))
    # divide in f32: a 0-d divisor takes no part in type promotion, so
    # x / xs would run in x's dtype (bf16); a dimensioned one-element view
    # promotes x inside the division, as JAX's x.astype(f32) / xs
    return _to_int8(x, xs.reshape([1] * x.dim())), xs


def _rescale_channels(acc, xs, ks):
    """acc (..., co) int32 -> f32 acc * (xs * ks), JAX's order."""
    return torch.mul(acc, xs * ks)


def conv_sums_reference(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The plain int32 sums of a 3x3 stride-1 'SAME' convolution: xq
    (B, C, H, W) int8 by kq (co, C, 3, 3) int8 -> (B*H*W, co), ``F.unfold``
    of the activations (exact in f64) and ``int_product`` with the
    kernel's (co, C*9) rows."""
    b, c, h, w = xq.shape
    cols = F.unfold(xq.to(torch.float64), 3, padding=1)      # (B, C*9, HW)
    cols = cols.transpose(1, 2).reshape(b * h * w, c * 9)
    return int_product(cols.to(torch.int32) if cols.device.type == 'cpu'
                       else cols, kq.reshape(kq.shape[0], -1).T)


def w8a8_conv_reference(x: torch.Tensor, weight: torch.Tensor):
    """3x3 stride-1 'SAME' convolution of x (B, C, H, W) float by the
    torch-layout kernel (co, C, 3, 3), both operands quantized to int8 ->
    (B, co, H, W) f32: ``conv_sums_reference`` rescaled."""
    b, c, h, w = x.shape
    xq, xs = quantize_tensor(x)
    kq, ks = quantize_conv_kernel(weight)
    out = _rescale_channels(conv_sums_reference(xq, kq), xs, ks)
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _im2col_int8(xq_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B*H*W, 9*C) int8: each pixel's 3x3 window with
    zero padding, in (ky, kx, c) order."""
    b, h, w, c = xq_nhwc.shape
    xp = F.pad(xq_nhwc, (0, 0, 1, 1, 1, 1))
    sb, sh, sw, sc = xp.stride()
    win = xp.as_strided((b, h, w, 3, 3, c), (sb, sh, sw, sh, sw, sc))
    return win.reshape(b * h * w, 9 * c)


def _im2col_products(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The card route's int32 sums of a 3x3 'SAME' convolution: xq
    (B, C, H, W) int8 by kq (co, C, 3, 3) int8 -> (B*H*W, co) int32, one
    ``torch._int_mm`` over the int8 im2col matrix, the kernel K-major."""
    co, c = kq.shape[:2]
    wk = kq.permute(0, 2, 3, 1).reshape(co, 9 * c)           # (ky, kx, c)
    return torch._int_mm(_im2col_int8(xq.permute(0, 2, 3, 1)), wk.T)


def w8a8_conv(x: torch.Tensor, weight: torch.Tensor):
    """3x3 'SAME' convolution with both operands int8 (per-tensor
    activation scale, per-output-channel kernel scale, from the float
    kernel each call) -> (B, co, H, W) f32, JAX's ``w8a8_conv`` in NCHW.
    CPU tensors: the plain version; CUDA tensors: ``torch._int_mm`` over an
    int8 im2col matrix."""
    if x.device.type == 'cpu':
        return w8a8_conv_reference(x, weight)
    if x.device.type != 'cuda':
        raise ValueError(f'w8a8_conv: unsupported device {x.device}')
    b, c, h, w = x.shape
    co = weight.shape[0]
    if tuple(weight.shape) != (co, c, 3, 3):
        raise ValueError(f'w8a8_conv: x {tuple(x.shape)}, kernel '
                         f'{tuple(weight.shape)}; a 3x3 kernel over C')
    _int_mm_shapes('w8a8_conv', b * h * w, 9 * c, co)
    xq, xs = quantize_tensor(x)
    kq, ks = quantize_conv_kernel(weight)
    acc = _im2col_products(xq, kq)
    w8a8_conv.launches += 1
    out = _rescale_channels(acc, xs, ks)
    return out.reshape(b, h, w, co).permute(0, 3, 1, 2)


w8a8_conv.launches = 0
