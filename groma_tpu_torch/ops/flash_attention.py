"""Flash attention: forward and backward with a key mask, causal or not.

Counterpart of ``groma_tpu/ops/flash_attention.py``.  Layout (B, H, S, D);
a (B, S_kv) key-validity mask applied to the scores before the row max;
rows with no valid key output 0 and have lse -1e30 (and get gradients 0).
Four TPU kernels become hand-written CUDA kernels:

* ``flash_fwd`` launches ``csrc/flash_attention_fwd.cu``, one kernel
  template: its bidirectional instantiation replaces ``_fwd_wholekv_kernel``
  (the DINOv2 encoder), its causal one ``_fwd_kernel`` (the LLaMA decoder).
  The TPU kernels split at 4096 keys because the whole-kv one holds every
  key in VMEM; the card's kernel streams key tiles at any length, so the
  port splits on the causal flag alone;
* ``flash_bwd`` launches ``csrc/flash_attention_bwd.cu``, one kernel
  templated on the causal flag: its causal instantiation replaces
  ``_bwd_fused_kernel`` (the LLaMA decoder), its bidirectional one
  ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel`` (the backward of every
  bidirectional call, e.g. DINOv2 trained with ``use_flash``; Sq != Skv
  allowed).  It is one pass over key tiles on wgmma fed by TMA; each key
  tile adds its part of dq into an f32 workspace that the wrapper zeroes,
  so dq's sums run in an order that varies from call to call, while dk
  and dv are bitwise deterministic.

* ``mha_reference`` and ``flash_attention_bwd_reference`` are the plain
  PyTorch versions, in f32 on any device.
* Each wrapper takes the plain version only for tensors on the CPU.  On
  CUDA tensors it launches its kernel (bf16 q/k/v, head dim 64 or 128) or
  raises; ``<wrapper>.launches`` counts its launches per instantiation:
  ``{'bidirectional': n, 'causal': n}``.
* ``flash_attention`` is the differentiable entry (an autograd Function):
  its forward keeps the lse when a gradient is wanted, its backward runs
  ``flash_bwd`` with the forward's mask flag.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def _valid(kv_mask, causal, sq, skv, device):
    """(B, 1, Sq, Skv) bool: key mask, and the causal band when asked."""
    valid = kv_mask[:, None, None, :].to(torch.bool)
    if causal:
        qi = torch.arange(sq, device=device)[:, None]
        kj = torch.arange(skv, device=device)[None, :]
        valid = valid & (kj <= qi + (skv - sq))
    return valid


def mha_reference(q, k, v, kv_mask=None, causal=False, scale=None):
    """Plain attention in f32 -> (out in q's dtype, lse (B, H, Sq) f32).

    The mask goes onto the scores before the row max; rows with no valid
    key give out 0 and lse NEG_INF."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    if kv_mask is None:
        kv_mask = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(_valid(kv_mask, causal, sq, skv, q.device), s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    dead = m <= NEG_INF / 2
    out = torch.where(dead, 0.0, torch.matmul(p, v.float()) / l)
    lse = torch.where(dead, NEG_INF, m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, do,
                                  causal=True, scale=None):
    """Plain backward from the lse recompute, in f32 -> (dq, dk, dv) in the
    inputs' dtype: p = exp(scale q.k - lse) where valid, else 0;
    delta = sum(do * out); ds = p (do.v - delta) scale."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    valid = _valid(kv_mask, causal, sq, skv, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- wrappers

def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(name, q, k, v, kv_mask, extra=()):
    """Raise one ValueError naming every reason the kernel refuses these
    tensors (device, shapes, dtypes, and the caller's ``extra`` ones)."""
    problems = []
    if q.device.type != 'cuda':
        problems.append(f'unsupported device {q.device}')
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if (k.shape != (b, h, skv, d) or v.shape != k.shape
            or kv_mask.shape != (b, skv) or d not in HEAD_DIMS):
        problems.append(f'shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v '
                        f'{tuple(v.shape)}, mask {tuple(kv_mask.shape)}; the '
                        f'kernel takes (B, H, S, D) with D in {HEAD_DIMS}')
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        problems.append(f'dtypes {q.dtype}, {k.dtype}, {v.dtype}; the kernel '
                        f'takes bf16')
    if any(t.device != q.device for t in (k, v, kv_mask)):
        problems.append('tensors on different devices')
    problems += extra
    if problems:
        raise ValueError(f'{name}: ' + '; '.join(problems))


def _launch_fwd(q, k, v, kv_mask, causal, scale, need_lse):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    b, h, sq, d = q.shape
    skv = k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    mask = kv_mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if need_lse else None
    status = library().groma_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr() if need_lse else None,
        b, h, sq, skv, d, float(scale), int(causal), stream_ptr(q))
    check(status, 'flash_attention_fwd')
    return out, lse


def flash_fwd(q, k, v, kv_mask, causal, scale, need_lse=True):
    """Forward -> (out, lse or None); causal skips the kv tiles above the
    diagonal."""
    if q.device.type == 'cpu':
        out, lse = mha_reference(q, k, v, kv_mask, causal, scale)
        return out, lse if need_lse else None
    _check_cuda('flash_fwd', q, k, v, kv_mask)
    res = _launch_fwd(q, k, v, kv_mask, causal, scale, need_lse)
    flash_fwd.launches['causal' if causal else 'bidirectional'] += 1
    return res


def flash_bwd(q, k, v, kv_mask, out, lse, do, causal, scale):
    """Backward -> (dq, dk, dv) in q's dtype, for either mask; causal skips
    the tile pairs above the diagonal."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_reference(q, k, v, kv_mask, out, lse, do,
                                             causal, scale)
    b, h, sq, d = q.shape
    bad_io = (out.shape != q.shape or do.shape != q.shape
              or lse.shape != (b, h, sq) or lse.dtype != torch.float32)
    _check_cuda('flash_bwd', q, k, v, kv_mask,
                ['out/do must match q, lse be (B, H, Sq) f32'] if bad_io
                else [])
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    do = _aligned(do.to(q.dtype))
    lse = lse.contiguous()
    # delta = rowsum(do * out), outside the kernel as on the TPU
    delta = (do.float() * out.float()).sum(-1).contiguous()
    mask = kv_mask.to(torch.uint8).contiguous()
    # dq's f32 workspace: every key tile adds its part into it
    dq_ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    status = library().groma_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_ws.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2], d,
        float(scale), int(causal), stream_ptr(q))
    check(status, 'flash_attention_bwd')
    flash_bwd.launches['causal' if causal else 'bidirectional'] += 1
    return dq, dk, dv


flash_fwd.launches = {'bidirectional': 0, 'causal': 0}
flash_bwd.launches = {'bidirectional': 0, 'causal': 0}


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        need_lse = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(q, k, v, kv_mask, causal, scale, need_lse)
        if need_lse:
            ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, kv_mask, out, lse, do, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask=None, causal=False, scale=None):
    """Flash attention over (B, H, S, D) tensors with an optional
    (B, S_kv) key mask; differentiable."""
    b, _, _, d = q.shape
    if kv_mask is None:
        kv_mask = torch.ones((b, k.shape[2]), dtype=torch.bool,
                             device=q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)
