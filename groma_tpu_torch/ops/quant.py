"""Weight-only int8 quantization and the int8 decode matmul.

Counterpart of ``groma_tpu/ops/quant.py``.  ``int8_matmul`` replaces the
TPU kernel ``_int8_matmul_kernel`` with the hand-written CUDA kernel in
``csrc/int8_matmul.cu`` (weight-byte bound at decode; see the source note).

* ``int8_matmul_reference`` is the plain PyTorch version, callable on any
  device: f32 dot of x against the int8 weights, then the per-column scale,
  in x's own dtype (the TPU kernel in interpret mode does not cast x to
  bf16 either).
* ``int8_matmul`` takes the plain version only for tensors on the CPU.  On
  a CUDA tensor it launches the kernel for M < 256, or, for M >= 256
  (prefill), dequantizes the weights to bf16 and runs ``torch.matmul`` as
  the TPU package leaves that product to XLA.  Anything else raises.
  ``int8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

DENSE_MIN_ROWS = 256      # from this many rows on, dequantize + torch.matmul


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as an IEEE division on every device.  PyTorch's CUDA
    kernel multiplies by the reciprocal when the divisor is a Python
    scalar, which can move a quantized value across a rounding tie."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_tile(m: int) -> int:
    return 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8


def _launch(x, w_q, scale):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    m, k = x.shape
    n = w_q.shape[1]
    mt = _row_tile(m)
    # split K until there are about two blocks per SM (64-column strips)
    blocks = _cdiv(n, 64) * _cdiv(m, mt)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(_cdiv(2 * sms, blocks), k // 512))
    k_chunk = _cdiv(_cdiv(k, splits), 64) * 64
    splits = _cdiv(k, k_chunk)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    status = library().groma_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, mt, k_chunk, splits, stream_ptr(x))
    check(status, 'int8_matmul')
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ int8 weights (K, N) with per-column scales -> (M, N).

    CPU tensors: the plain version.  CUDA tensors: x bf16 contiguous,
    w_q int8 contiguous, scale f32 (N,); the hand-written kernel for
    M < 256, dequantize + torch.matmul from 256 rows on."""
    if x.device.type == 'cpu':
        return int8_matmul_reference(x, w_q, scale)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_matmul: unsupported device {x.device}')
    m, k = x.shape
    if w_q.dim() != 2 or w_q.shape[0] != k or scale.shape != (w_q.shape[1],):
        raise ValueError(f'int8_matmul: shapes x {tuple(x.shape)}, '
                         f'w {tuple(w_q.shape)}, scale {tuple(scale.shape)}')
    if (x.dtype, w_q.dtype, scale.dtype) != (torch.bfloat16, torch.int8,
                                             torch.float32):
        raise ValueError(f'int8_matmul: dtypes {x.dtype}, {w_q.dtype}, '
                         f'{scale.dtype}; the kernel takes bf16, int8, f32')
    if not (w_q.device == scale.device == x.device):
        raise ValueError('int8_matmul: tensors on different devices')
    if m >= DENSE_MIN_ROWS:
        return x @ dequantize_weight(w_q, scale)
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()) or w_q.data_ptr() % 16:
        raise ValueError('int8_matmul: the kernel takes contiguous tensors '
                         'with 16-byte-aligned weights')
    return _launch(x, w_q, scale)


int8_matmul.launches = 0
