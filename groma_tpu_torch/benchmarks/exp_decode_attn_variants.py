"""Decode-attention structure probe on the H100: grid, S blocks, launches.

Counterpart of the TPU probe ``benchmarks/exp_decode_attn_variants.py``
(kernels ``k_floor``, ``k_mxu``, ``k_mxu_sblk``) at the serving shapes B=8,
H=32, S=1024, D=128 over an int8 KV cache.  It sweeps how the grid carves
the KV stream, not what the body computes.  One hand-written kernel
template (``csrc/probe_decode_attn.cu``) over three bodies:

  floor             sum_s k8 + sum_s v8 + sum_s ks + sum_s vs + bias[b, 0]:
                    every KV byte touched once, the structure's memory floor
  mxu               the whole-S int8 body of #2
  mxu sbN           the same body over S blocks of N positions, each with its
                    own max, denominator and requantized p, run in parallel
                    and combined by a second kernel

and four structures: ``hbN``, N heads a block of eight warps, one after
another (hb1 is #2's first grid, one block per (b, head)); ``sbN``;
``Lstack``, one launch over all L layers (independent layers: a bound on
what fewer launches are worth, not a drop-in).  Every variant is fed as
#2's kernel is fed: each (b, h) row's K and then V stream through a ring
of 64-row stages filled by 1-d bulk copies, which one producer thread
keeps in flight across the block's heads, with the row's scales and the
bias in bulk copies of their own (so S and the S blocks are multiples of
4); a variant's time is its grid and body, not its loads.  ``mxu (shipped)`` launches the port's #2 kernel (a cluster of
CTAs per (b, head)); ``plain (torch)`` is its plain version on the card.
Times are per 32-layer step, measured over L layers (``--layers``,
default 8: about 0.55 GB of KV on the card).

* ``floor_reference``, ``int8_decode_attention_reference`` (#2's) and
  ``mxu_sblk_reference`` are the plain PyTorch versions, on any device.
* ``probe_decode_attention(..., body, hb, sblk)`` takes them only for CPU
  tensors; on CUDA tensors it launches the kernel or raises;
  ``probe_decode_attention.launches`` counts launches per body.
* ``ring_plan`` sizes a block's ring and scale buffers, and ``ring_items``
  lists the stages a block streams, in the kernel's order.

Run on the card:
``python -m groma_tpu_torch.benchmarks.exp_decode_attn_variants``
(``--device cpu`` runs the plain versions on the host clock).
"""

from __future__ import annotations

import argparse

import torch

from groma_tpu_torch.checkpoint.loader import resolve_device
from groma_tpu_torch.ops.decode_attention import (
    int8_decode_attention, int8_decode_attention_reference)
from groma_tpu_torch.ops.quant import true_div
from groma_tpu_torch.utils.profiling import (H100_BYTES_PER_S, H100_INT8_OPS,
                                             bound, timer_for)

B, NH, S, HD = 8, 32, 1024, 128
L_STEP = 32
BODIES = ('floor', 'mxu', 'mxu_sblk')
HEADS_A_BLOCK = (1, 8, 16, 32)
MAX_SBLK = 4096
PARITY_TOL = 2e-2       # the TPU probe's allclose(atol, rtol) gate
STAGE_ROWS = 64         # KV rows of one ring stage (8 KB)
MAX_STAGES = 4          # deeper rings were no faster (PERF.md §6, PR 21)
SM_SMEM = 228 * 1024     # an SM's, of which each block's runtime takes 1 KB
STATIC_SMEM = 5 * 1024   # the kernel's static shared memory, at most


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def ring_smem(body: str, sblk: int, stages: int, nbuf: int) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    ring; ``nbuf`` x (ks, vs) of the S block; for the mxu bodies the bias,
    the scores and p8."""
    mxu = 8 * _pad(sblk, 4) + _pad(sblk, 16) if body != 'floor' else 0
    return stages * STAGE_ROWS * HD + nbuf * 8 * _pad(sblk, 4) + mxu


def ring_plan(body: str, sblk: int, hb: int) -> tuple:
    """(stages, nbuf) of a block over S blocks of ``sblk`` positions and
    ``hb`` heads: two blocks to an SM, two scale buffers where more than
    one head shares the block and they leave at least four stages, else
    one, and as many 8 KB stages as then fit, 2 to 4."""
    budget = SM_SMEM // 2 - 1024 - STATIC_SMEM
    for nbuf in ((2, 1) if hb > 1 else (1,)):
        room = budget - ring_smem(body, sblk, 0, nbuf)
        stages = min(MAX_STAGES, room // (STAGE_ROWS * HD))
        if stages >= (4 if nbuf == 2 else 2):
            return stages, nbuf
    raise ValueError(f'no ring fits two blocks an SM at sblk {sblk}')


def ring_items(s: int, sblk: int, hb: int) -> list:
    """Per S block, the ring items of a block of ``hb`` heads in the order
    the producer issues them: for each head, its K stages and then its V
    stages, as (head, 'k' or 'v', first position, rows)."""
    out = []
    for s0 in range(0, s, sblk):
        n = min(s, s0 + sblk) - s0
        out.append([(h, kv, s0 + r, min(STAGE_ROWS, n - r))
                    for h in range(hb) for kv in 'kv'
                    for r in range(0, n, STAGE_ROWS)])
    return out


def floor_reference(q, k8, ks, v8, vs, bias):
    """(B, H, 1, D) f32: sum_s k8 + sum_s v8 (exact) + sum_s ks + sum_s vs
    + bias[b, 0, 0, 0]; q is read by the TPU body only as q * 0."""
    t = (k8.to(torch.int64).sum(2) + v8.to(torch.int64).sum(2)).to(
        torch.float32)                                         # (B, H, D)
    out = t + ks.sum(-1, keepdim=True) + vs.sum(-1, keepdim=True) \
        + bias[:, 0, 0, :1, None]
    return out[:, :, None, :]


def _sblk_parts(q, k8, ks, v8, vs, bias, sblk):
    """Per S block: (m, d, o * r, r) of the whole-S body on that block."""
    b, h, s, d = k8.shape
    nsb = -(-s // sblk)
    pad = nsb * sblk - s
    qf = q[:, :, 0].to(torch.float32)
    amax = qf.abs().amax(-1, keepdim=True)
    qs = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q8 = torch.round(qf / qs)
    sc = torch.einsum('bhd,bhsd->bhs', q8.double(), k8.double()).float()
    sc = sc * (qs * d ** -0.5) * ks + bias[:, 0].to(torch.float32)
    # pad positions: a score of -inf and a v scale of 0 add nothing
    sc = torch.nn.functional.pad(sc, (0, pad), value=float('-inf'))
    vsp = torch.nn.functional.pad(vs, (0, pad))
    sc, vsp = sc.reshape(b, h, nsb, sblk), vsp.reshape(b, h, nsb, sblk)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    den = p.sum(-1, keepdim=True)
    ps = p * vsp
    r = ps.amax(-1, keepdim=True)
    r = torch.where(r > 0, true_div(r, 127.0), torch.ones_like(r))
    p8 = torch.round(ps / r)
    v8p = torch.nn.functional.pad(v8, (0, 0, 0, pad)).reshape(
        b, h, nsb, sblk, d)
    o = torch.einsum('bhns,bhnsd->bhnd', p8.double(), v8p.double()).float()
    return m, den, o * r, r


def mxu_sblk_reference(q, k8, ks, v8, vs, bias, sblk: int):
    """The S-blocked body: each block of ``sblk`` positions with its own
    max, denominator and requantized p, then o = sum_i o_i e^(m_i - m) /
    max(sum_i d_i e^(m_i - m), 1e-30) -> (B, H, 1, D) f32."""
    m, den, o, _ = _sblk_parts(q, k8, ks, v8, vs, bias, sblk)
    w = torch.exp(m - m.amax(2, keepdim=True))             # (B, H, nsb, 1)
    out = (o * w).sum(2) / torch.clamp((den * w).sum(2), min=1e-30)
    return out[:, :, None, :]


def mxu_sblk_step(q, k8, ks, v8, vs, bias, sblk: int):
    """(B, H, 1, 1): the most one requantized-p unit of any block can move
    an output, 127 max_i(r_i e^(m_i - m)) / sum_i d_i e^(m_i - m)."""
    m, den, _, r = _sblk_parts(q, k8, ks, v8, vs, bias, sblk)
    w = torch.exp(m - m.amax(2, keepdim=True))
    step = 127 * (r * w).amax(2) / torch.clamp((den * w).sum(2), min=1e-30)
    return step[:, :, None, :]


def plain_version(body, sblk):
    """The plain PyTorch version of ``body`` on one layer."""
    if body == 'floor':
        return floor_reference
    if body == 'mxu':
        return int8_decode_attention_reference
    return lambda *a: mxu_sblk_reference(*a, sblk)


def probe_decode_attention(q, k8, ks, v8, vs, bias, body: str = 'mxu',
                           hb: int = 1, sblk: int | None = None):
    """q (B, H, 1, D); k8/v8 (B, H, S, D) int8, or (L, B, H, S, D) for L
    independent layers in one launch; ks/vs (B, H, S) or (L, B, H, S) f32;
    bias (B, 1, 1, S) f32 -> (B, H, 1, D) or (L, B, H, 1, D) f32.

    CPU tensors: the plain version of ``body``.  CUDA tensors: q f32,
    D = 128, all contiguous and 16-byte aligned, hb in (1, 8, 16, 32)
    dividing H, S a multiple of 4; ``sblk`` only for 'mxu_sblk' (S blocks
    of that many positions, a multiple of 4, at most 4096), and whole-S
    bodies take S <= 4096.  The ring is ``ring_plan``'s."""
    if body not in BODIES or (sblk is None) != (body != 'mxu_sblk'):
        raise ValueError(f'probe_decode_attention: body {body!r} with sblk '
                         f'{sblk}: sblk is for mxu_sblk alone')
    stacked = k8.dim() == 5
    if q.device.type == 'cpu':
        fn = plain_version(body, sblk)
        if not stacked:
            return fn(q, k8, ks, v8, vs, bias)
        return torch.stack([fn(q, k8[i], ks[i], v8[i], vs[i], bias)
                            for i in range(k8.shape[0])])
    lyr = k8.shape[0] if stacked else 1
    b, h, one, d = q.shape
    s = k8.shape[-2]
    kv_shape = ((lyr,) if stacked else ()) + (b, h, s, d)
    sb = sblk or s
    if (one != 1 or d != HD or k8.shape != kv_shape or v8.shape != kv_shape
            or ks.shape != kv_shape[:-1] or vs.shape != kv_shape[:-1]
            or bias.shape != (b, 1, 1, s) or hb not in HEADS_A_BLOCK
            or h % hb or not 1 <= sb <= MAX_SBLK or s % 4 or sb % 4):
        raise ValueError(f'probe_decode_attention: q {tuple(q.shape)}, k8 '
                         f'{tuple(k8.shape)}, ks {tuple(ks.shape)}, bias '
                         f'{tuple(bias.shape)}, hb {hb}, sblk {sblk}')
    tensors = (q, k8, ks, v8, vs, bias)
    if (q.dtype, k8.dtype, v8.dtype, ks.dtype, vs.dtype, bias.dtype) != (
            torch.float32, torch.int8, torch.int8, torch.float32,
            torch.float32, torch.float32) or not all(
            t.device == q.device and t.is_contiguous()
            and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError('probe_decode_attention: the kernel takes '
                         'contiguous, 16-byte aligned q/ks/vs/bias f32 and '
                         'k8/v8 int8 on one device')
    if q.device.type != 'cuda':
        raise ValueError(f'probe_decode_attention: unsupported device '
                         f'{q.device}')
    from groma_tpu_torch.ops.cuda_lib import check, probe_library, stream_ptr
    out = torch.empty(kv_shape[:-2] + (1, d), dtype=torch.float32,
                      device=q.device)
    parts = [None] * 3
    if body == 'mxu_sblk':
        nsb = -(-s // sb)
        mdp = torch.empty((2, lyr, b, h, nsb), dtype=torch.float32,
                          device=q.device)
        op = torch.empty((lyr, b, h, nsb, d), dtype=torch.float32,
                         device=q.device)
        parts = [mdp[0].data_ptr(), mdp[1].data_ptr(), op.data_ptr()]
    stages, nbuf = ring_plan(body, sb, hb)
    status = probe_library().groma_probe_decode_attn(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), out.data_ptr(), *parts, lyr, b, h, s,
        d, BODIES.index(body), hb, sb, stages, nbuf, stream_ptr(q))
    check(status, f'probe_decode_attention ({body})')
    probe_decode_attention.launches[body] += 1
    return out


probe_decode_attention.launches = {body: 0 for body in BODIES}


def make_inputs(n_layers: int, device, seed: int = 0):
    """The TPU probe's fixtures for ``n_layers`` layers: k8/v8 uniform in
    [-127, 127), ks/vs uniform in [1e-3, 1.1e-2), q ~ N(0, 1) f32, a zero
    bias.  -> (q, k8, ks, v8, vs, bias), the KV stacked (L, B, H, S, .)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kv = (n_layers, B, NH, S, HD)
    k8 = torch.randint(-127, 127, kv, generator=gen, device=device,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 127, kv, generator=gen, device=device,
                       dtype=torch.int8)
    ks = torch.rand(kv[:-1], generator=gen, device=device) * 1e-2 + 1e-3
    vs = torch.rand(kv[:-1], generator=gen, device=device) * 1e-2 + 1e-3
    q = torch.randn((B, NH, 1, HD), generator=gen, device=device)
    bias = torch.zeros((B, 1, 1, S), dtype=torch.float32, device=device)
    return q, k8, ks, v8, vs, bias


def layer_bound(b=B, h=NH, s=S, d=HD):
    """(ms, by) of one layer on one H100: the KV bytes and scales, the bias,
    q and out once; the two int8 dots at the int8 rate."""
    return bound(2 * b * h * s * d + 2 * b * h * s * 4 + b * s * 4
                 + 2 * b * h * d * 4, 4 * b * h * s * d, H100_INT8_OPS)


def variants():
    """(name, body, hb, sblk, stacked): the TPU probe's list, plus hb1 (one
    block per (b, head)) for each body; 'mxu (shipped)' and 'plain (torch)'
    are timed apart."""
    return [('floor hb1', 'floor', 1, None, False),
            ('floor hb8', 'floor', 8, None, False),
            ('floor hb16', 'floor', 16, None, False),
            ('floor hb32', 'floor', 32, None, False),
            ('mxu hb1', 'mxu', 1, None, False),
            ('mxu hb8', 'mxu', 8, None, False),
            ('mxu hb16', 'mxu', 16, None, False),
            ('mxu hb32', 'mxu', 32, None, False),
            ('mxu hb1 sb256', 'mxu_sblk', 1, 256, False),
            ('mxu hb8 sb256', 'mxu_sblk', 8, 256, False),
            ('mxu hb32 sb256', 'mxu_sblk', 32, 256, False),
            ('mxu hb32 sb512', 'mxu_sblk', 32, 512, False),
            ('floor Lstack hb8', 'floor', 8, None, True),
            ('mxu Lstack hb8', 'mxu', 8, None, True),
            ('mxu Lstack hb16', 'mxu', 16, None, True)]


def main(argv=None):
    """Prints the probe's table; returns the names of the variants that
    failed the parity gate (every mxu variant against the shipped body)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions on the host clock)")
    ap.add_argument('--layers', type=int, default=8,
                    help='layers of KV fixtures the step is measured over')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timer, label = timer_for(device)
    on_card = device.startswith('cuda')      # shares only from the card
    n_layers = args.layers
    q, k8, ks, v8, vs, bias = make_inputs(n_layers, device, args.seed)
    kv_bytes = 2 * (B * NH * S * HD + 4 * B * NH * S)
    roof = kv_bytes * L_STEP / H100_BYTES_PER_S
    print(f'# roofline {roof * 1e3:.2f} ms/{L_STEP}-layer step (KV bytes '
          f'over 3.35 TB/s; measured at L={n_layers}) [{label}]', flush=True)

    def call(body, hb, sblk, stacked, i=0):
        if stacked:
            return probe_decode_attention(q, k8, ks, v8, vs, bias, body, hb,
                                          sblk)[i]
        return probe_decode_attention(q, k8[i], ks[i], v8[i], vs[i], bias,
                                      body, hb, sblk)

    def all_layers(fn):
        return lambda: [fn(i) for i in range(n_layers)]

    shipped = int8_decode_attention(q, k8[0], ks[0], v8[0], vs[0], bias)
    bad = []
    for name, *v in variants():
        if v[0] != 'floor':
            ok = torch.allclose(call(*v), shipped, atol=PARITY_TOL,
                                rtol=PARITY_TOL)
            print(f'# parity {name}: {"OK" if ok else "MISMATCH"}',
                  flush=True)
            if not ok:
                bad.append(name)

    timed = [('mxu (shipped)', all_layers(lambda i: int8_decode_attention(
        q, k8[i], ks[i], v8[i], vs[i], bias)))]
    for name, body, hb, sblk, stacked in variants():
        if name in bad:
            continue
        timed.append((name, (lambda _v=(body, hb, sblk): call(*_v, True))
                      if stacked else all_layers(
                          lambda i, _v=(body, hb, sblk): call(*_v, False, i))))
    timed.append(('plain (torch)', all_layers(
        lambda i: int8_decode_attention_reference(q, k8[i], ks[i], v8[i],
                                                  vs[i], bias))))
    for name, fn in timed:
        dt = timer(fn) * 1e-3 * L_STEP / n_layers
        share = (f'{dt / roof:.2f}x roofline, {roof / dt * 100:5.1f} % of the '
                 f'bound' if on_card else 'host clock')
        print(f'{name:18s}: {dt * 1e3:7.2f} ms/{L_STEP}-layer step ({share})',
              flush=True)
    return bad


if __name__ == '__main__':
    main()
