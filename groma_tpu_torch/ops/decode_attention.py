"""Single-token decode attention over an int8 KV cache.

Counterpart of ``groma_tpu/ops/decode_attention.py``.  ``int8_decode_attention``
replaces the TPU kernel ``_kernel`` with the hand-written CUDA kernel in
``csrc/decode_attention.cu`` (KV-byte bound; see the source note): one
(b, h) split over a thread-block cluster, reading only the slots the mask
keeps.  Unlike the TPU wrapper, nothing here falls back when S % 128 != 0:
the served cache has 2112 slots and the kernel takes any S up to
``MAX_SEQ``.

* ``int8_decode_attention_reference`` is the plain PyTorch version, on any
  device, in the TPU kernel's order: q quantized per (b, h) row, int8 q.k,
  scale and mask bias, f32 softmax numerator and denominator, the v scale
  folded into p, p requantized to int8, int8 p.v, times r / denom.  Both
  integer dots run in f64, where they are exact.
* ``decode_attention_plan`` (the cluster's size), ``kept_slots`` and
  ``rank_chunks`` (which slots the kernel reads, and which CTA reads them)
  are the kernel's host-side schedule, in plain Python for the tests.
* ``int8_decode_attention`` takes the plain version only for CPU tensors;
  on CUDA tensors it launches the kernel or raises.
  ``int8_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from groma_tpu_torch.ops.quant import true_div

HEAD_DIM = 128
MAX_SEQ = 4096       # the kernel's list of kept slots holds uint16
CHUNK_ROWS = 64      # kept slots of one chunk of the list, one ring stage
MAX_CLUSTER = 8      # the portable cluster size: the kernel's limit
PLAN_CLUSTER = 4     # the plan's: larger clusters are placed worse
KEEP_ABOVE = -1e29   # a slot whose bias is above this is read
SMEM_PER_SM = 227 * 1024     # shared memory a CTA may use on an H100 SM
STATIC_SMEM = 10 * 1024      # the kernel's static shared memory, rounded up


def decode_attention_smem(s: int, stages: int) -> int:
    """The kernel's dynamic shared memory: ``stages`` ring stages of
    ``CHUNK_ROWS`` 128-byte rows, the kept list (2 bytes a slot) and 13
    bytes a slot of scales, scores and p8 (as csrc/decode_attention.cu's
    ``smem_bytes``)."""
    def align16(x):
        return -(-x // 16) * 16
    return stages * CHUNK_ROWS * HEAD_DIM + align16(2 * s) + 12 * s \
        + align16(s)


def decode_attention_plan(b: int, h: int, s: int, sms: int) -> tuple:
    """(C, stages) on a card with ``sms`` SMs: two CTAs a SM.  C, the CTAs
    of one (b, h)'s cluster: as many as fill about one wave of two CTAs a
    SM, at least 1 and at most ``PLAN_CLUSTER``, and no more than the
    row's chunks.  stages, the depth of each
    CTA's ring (a power of two, 2 to 8): the most with which two CTAs
    share an SM's shared memory."""
    c = max(1, min(PLAN_CLUSTER, 2 * sms // (b * h), -(-s // CHUNK_ROWS)))
    stages = 8
    while stages > 2 and 2 * (decode_attention_smem(s, stages)
                              + STATIC_SMEM) > SMEM_PER_SM:
        stages //= 2
    return c, stages


def kept_slots(bias_row):
    """(S,) bias -> the slots the kernel reads, in order: those whose bias
    is above ``KEEP_ABOVE``, or every slot when none is (the uniform-p row).
    Under the contract's bias (0 or -1e30) a masked slot adds exactly
    nothing whenever one slot is kept: exp(-1e30 - m) is 0 in f32."""
    kept = torch.nonzero(bias_row > KEEP_ABOVE).flatten()
    return kept if kept.numel() else torch.arange(bias_row.shape[0],
                                                  device=bias_row.device)


def rank_chunks(n: int, c: int) -> list:
    """For each rank of a cluster of ``c``, the [start, end) ranges of the
    kept list it reads: the list's 64-slot chunks, chunk j to rank j % c,
    in the kernel's order."""
    return [[(j * CHUNK_ROWS, min(n, (j + 1) * CHUNK_ROWS))
             for j in range(r, -(-n // CHUNK_ROWS), c)] for r in range(c)]


def _requantized_probs(q, k8, ks, vs, mask_bias):
    """-> (p8 (B, H, S) as floats, r (B, H, 1), denom (B, H, 1))."""
    d = q.shape[-1]
    qf = q[:, :, 0].to(torch.float32)                          # (B, H, D)
    amax = qf.abs().amax(-1, keepdim=True)
    qs = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q8 = torch.round(qf / qs)
    s = torch.einsum('bhd,bhsd->bhs', q8.double(), k8.double()).float()
    s = s * (qs * d ** -0.5) * ks + mask_bias[:, 0].to(torch.float32)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    ps = p * vs
    r = ps.amax(-1, keepdim=True)
    r = torch.where(r > 0, true_div(r, 127.0), torch.ones_like(r))
    return torch.round(ps / r), r, denom


def int8_decode_attention_reference(q, k8, ks, v8, vs, mask_bias):
    """q (B, H, 1, D); k8/v8 (B, H, S, D) int8; ks/vs (B, H, S) f32;
    mask_bias (B, 1, 1, S) f32 (0 or -1e30) -> (B, H, 1, D) f32."""
    p8, r, denom = _requantized_probs(q, k8, ks, vs, mask_bias)
    o = torch.einsum('bhs,bhsd->bhd', p8.double(), v8.double()).float()
    return (o * (r / torch.clamp(denom, min=1e-30)))[:, :, None, :]


def p8_step(q, k8, ks, vs, mask_bias):
    """(B, H, 1, 1): the most one requantized-p unit can move an output,
    127 * r / denom.  Two implementations whose f32 exp or sums differ in
    the last bit may round a p that sits on a .5 tie differently; this is
    the unit their outputs may then differ by."""
    _, r, denom = _requantized_probs(q, k8, ks, vs, mask_bias)
    return (127.0 * r / torch.clamp(denom, min=1e-30))[:, :, None, :]


def int8_decode_attention(q, k8, ks, v8, vs, mask_bias, plan=None):
    """Same contract as the plain version.  CUDA tensors: q f32 or bf16
    (cast to f32 as the TPU kernel does), D = 128, S <= MAX_SEQ, all
    contiguous, k8 and v8 16-byte aligned.  ``plan``: (C, stages), the
    CTAs of a (b, h) (1..8) and their ring's depth (a power of two, 2..16);
    default ``decode_attention_plan``'s."""
    if q.device.type == 'cpu':
        return int8_decode_attention_reference(q, k8, ks, v8, vs, mask_bias)
    if q.device.type != 'cuda':
        raise ValueError(f'int8_decode_attention: unsupported device '
                         f'{q.device}')
    b, h, one, d = q.shape
    s = k8.shape[2]
    if (one != 1 or d != HEAD_DIM or k8.shape != (b, h, s, d)
            or v8.shape != k8.shape or ks.shape != (b, h, s)
            or vs.shape != ks.shape or mask_bias.shape != (b, 1, 1, s)
            or not 1 <= s <= MAX_SEQ):
        raise ValueError(
            f'int8_decode_attention: shapes q {tuple(q.shape)}, '
            f'k8 {tuple(k8.shape)}, ks {tuple(ks.shape)}, '
            f'bias {tuple(mask_bias.shape)}; the kernel takes D = '
            f'{HEAD_DIM} and 1 <= S <= {MAX_SEQ}')
    if (k8.dtype, v8.dtype, ks.dtype, vs.dtype, mask_bias.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32,
            torch.float32) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('int8_decode_attention: dtypes must be q f32/bf16, '
                         'k8/v8 int8, ks/vs/bias f32')
    tensors = (k8, ks, v8, vs, mask_bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError('int8_decode_attention: tensors on different devices')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('int8_decode_attention: the kernel takes contiguous '
                         'tensors')
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError('int8_decode_attention: k8 and v8 must be 16-byte '
                         'aligned (bulk copies)')
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    c, stages = plan or decode_attention_plan(
        b, h, s, torch.cuda.get_device_properties(q.device)
        .multi_processor_count)
    if not 1 <= c <= MAX_CLUSTER or stages not in (2, 4, 8, 16):
        raise ValueError(f'int8_decode_attention: plan {(c, stages)}: C in '
                         f'1..{MAX_CLUSTER}, stages 2, 4, 8 or 16')
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    status = library().groma_int8_decode_attention(
        qf.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, h, s, d, c,
        stages, stream_ptr(q))
    check(status, 'int8_decode_attention')
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0
