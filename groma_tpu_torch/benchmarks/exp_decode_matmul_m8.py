"""Do int8 tensor cores beat weight streaming for the M=8 decode matmul?

Counterpart of the TPU probe ``benchmarks/exp_decode_matmul_m8.py``
(kernels ``_w8a8_kernel`` and ``_int4_a8_kernel``).  The four 7B layer
matmuls (qkv 4096x12288, o 4096x4096, gate_up 4096x22016, down 11008x4096)
at M=8, summed and scaled to a 32-layer step, through:

  bf16 dot          torch.matmul on bf16 weights (a library yardstick)
  int8 kernel       the port's int8_matmul (#1, weight streaming)
  w8a8 xla          per-row int8 activation quant, then torch._int_mm (x
                    padded to 32 rows: it takes M > 16), then the scales
  w8a8 kernel       the same in hand-written CUDA
                    (``csrc/probe_decode_matmul_m8.cu``): a quantizer, then
                    the int8 products on mma.sync m16n8k32 s8 with the
                    weights as A and the batch of 8 as N, fed by #1's TMA
                    ring
  int4 kernel       the port's int4_matmul (#7, bf16-plane weight streaming)
  int4-a8 kernel    biased nibble planes as int8 on the same tensor cores
                    (#7's ring), folded per 256-row scale block, minus 8
                    sum(xq)

* ``act_quant``, ``w8a8_reference`` and ``int4_a8_reference`` are the plain
  PyTorch versions, on any device (integer dots in f64, where they are
  exact; the TPU kernels' order of f32 operations).
* ``w8a8_matmul`` and ``int4_a8_matmul`` take them only for CPU tensors; on
  CUDA tensors they launch their kernel or raise; ``<wrapper>.launches``
  counts calls (each runs two kernels: the quantizer, then the product as
  a programmatic dependent launch).
* ``m8_plan`` gives a call's split of the weight rows, ``m8_stages`` the
  stages each split streams and ``m8_folds`` int4-a8's fold ranges;
  ``xq_position`` is where the quantizer puts xq[m, k] in its row.

Run on the card: ``python -m groma_tpu_torch.benchmarks.exp_decode_matmul_m8``
(``--device cpu`` runs the plain versions on the host clock).
"""

from __future__ import annotations

import argparse

import torch

from groma_tpu_torch.benchmarks.exp_int4_unpack import unpack_plan
from groma_tpu_torch.checkpoint.loader import resolve_device
from groma_tpu_torch.ops import quant, quant4
from groma_tpu_torch.ops.quant import (int8_matmul, quantize_weight,
                                       true_div)
from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, int4_matmul,
                                        quantize_weight_int4)
from groma_tpu_torch.utils.profiling import H100_INT8_OPS, bound, timer_for

D, F = 4096, 11008
SHAPES = [('qkv', D, 3 * D), ('o', D, D), ('gu', D, 2 * F), ('down', F, D)]
M = 8
L = 32
INT_MM_ROWS = 32    # torch._int_mm takes more than 16 rows
FORMS = ('w8a8', 'int4')
STAGE_ROWS = {'w8a8': quant.DECODE_TILE[0], 'int4': quant4.DECODE_TILE[0]}
TILE_COLS = 128     # weight columns a CTA
STAGES = 4          # the product's ring
XQ_CHUNK = 64       # k of one xq box and of one xq sum
MAX_K = 32768       # the quantizer: 1024 threads x 4 loads of 8 values
N_MULTIPLE = 16     # the weights' tensor map: 16-byte row pitch


def stage_bytes(form: str) -> int:
    """Bytes of one stage of the product's ring: the weight box, xq's two
    8 x 64 boxes and, for int4, two scale rows and two xq-sum rows (1 KB
    aligned)."""
    box = STAGE_ROWS[form] * TILE_COLS + 2 * M * XQ_CHUNK
    if form == 'w8a8':
        return box
    return _cdiv(box + 2 * TILE_COLS * 4 + 2 * M * 4, 1024) * 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def act_quant(x: torch.Tensor):
    """Per-row int8 quantization (the TPU probe's ``_act_q``) -> (xq int8
    (M, K), s f32 (M,)): s = max|x| / 127 (IEEE), 1 for a zero row;
    xq = clip(round(x / s), -127, 127), half to even."""
    xf = x.to(torch.float32)
    a = xf.abs().amax(-1)
    s = torch.where(a > 0, true_div(a, 127.0), torch.ones_like(a))
    q = torch.clamp(torch.round(xf / s[:, None]), -127, 127)
    return q.to(torch.int8), s


def w8a8_reference(x, wq, sc):
    """x (M, K) @ int8 wq (K, N) with per-column scales sc (N,), x
    quantized per row -> (M, N) f32 = int32 dot * s[m] * sc[n]."""
    xq, xs = act_quant(x)
    acc = (xq.double() @ wq.double()).to(torch.float32)
    return acc * xs[:, None] * sc[None, :]


def int4_a8_reference(x, packed, scale, block: int = INT4_BLOCK):
    """x (M, K) @ #7's packed int4 (K/2, N) with (K/block, N) scales, x
    quantized per row -> (M, N) f32: per scale block b, (xq_b . nib_b -
    8 sum(xq_b)) * scale[b], summed over b in order, times s[m]."""
    xq, xs = act_quant(x)
    kh, n = packed.shape
    m, k = xq.shape
    nblk = k // block
    pi = packed.to(torch.int32)
    nib = torch.cat([pi & 0xF, pi >> 4]).double()       # (K, N), k order
    xb = xq.double().reshape(m, nblk, block)
    part = torch.einsum('mbk,bkn->mbn', xb, nib.reshape(nblk, block, n))
    t = (part - 8 * xb.sum(-1)[..., None]).to(torch.float32) * scale[None]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for b in range(nblk):
        acc = acc + t[:, b]
    return acc * xs[:, None]


def m8_plan(form: str, k: int, n: int, sms: int) -> dict:
    """The product's launch for x (8, K) on a card with ``sms`` SMs: the
    weight rows (packed rows for int4) cut into ``splits`` ranges of
    ``split_rows`` (whole stages of ``stage_rows``, the last range shorter
    and not empty), ``col_tiles`` CTAs of 128 columns a split, and each
    CTA's dynamic shared memory.  w8a8 takes #1's decode split
    (``quant.decode_plan(8, K, N, sms)``), int4 #10's (#7's
    ``quant4.decode_plan(K, N, sms)`` with at least two stages a split
    where K has them: ``exp_int4_unpack.unpack_plan``)."""
    rows = STAGE_ROWS[form]
    if form == 'w8a8':
        split_rows, splits = quant.decode_plan(M, k, n, sms)
    else:
        plan = unpack_plan(k // 2, n, sms)
        split_rows, splits = plan['split_rows'], plan['splits']
    return {'split_rows': split_rows, 'splits': splits,
            'col_tiles': _cdiv(n, TILE_COLS), 'stage_rows': rows,
            'smem': 1024 + STAGES * stage_bytes(form) + 2 * STAGES * 8}


def m8_stages(form: str, k: int, n: int, sms: int) -> list:
    """The first weight row of each stage each split streams, in the
    kernel's order."""
    plan = m8_plan(form, k, n, sms)
    rows, per = (k // 2 if form == 'int4' else k), plan['split_rows']
    return [list(range(z * per, min(rows, (z + 1) * per), plan['stage_rows']))
            for z in range(plan['splits'])]


def m8_folds(k: int, n: int, sms: int) -> list:
    """int4-a8's folds in each split, in the kernel's order: (plane, k0,
    k1), the range of K whose int32 dot is scaled once (plane 0 the low
    nibbles, k < K/2; 1 the high ones).  A plane's fold ends where its
    scale block ends or the split ends."""
    kh, rows = k // 2, STAGE_ROWS['int4']
    out = []
    for stages in m8_stages('int4', k, n, sms):
        start = [stages[0], kh + stages[0]]
        folds = []
        for i, r in enumerate(stages):
            last = i + 1 == len(stages)
            for plane, end in ((0, r + rows), (1, kh + r + rows)):
                if last or end % INT4_BLOCK == 0:
                    folds.append((plane, start[plane], end))
                    start[plane] = end
        out.append(folds)
    return out


def xq_position(m: int, k: int) -> int:
    """Where the quantizer puts xq[m, k] in row m (the kernel's
    ``xq_pos``): the 64-k chunk of k, its 16-k group XORed with (m // 2) %
    4, and inside the group the product's position of k (position 4t + i
    holds k 2t + i % 2 + 8 (i // 2) of the group)."""
    u = k % 16
    p = 4 * ((u % 8) // 2) + u % 2 + 2 * (u // 8)
    return k - k % 64 + 16 * ((k // 16 % 4) ^ (m // 2 % 4)) + p


def _launch(name, x, w, scale, int4: bool):
    m, k = x.shape if x.dim() == 2 else (0, 0)
    n = w.shape[1] if w.dim() == 2 else 0
    rows = k // 2 if int4 else k
    if (m != M or not k or k % INT4_BLOCK or k > MAX_K or not n
            or n % N_MULTIPLE or w.shape[0] != rows
            or x.dtype != torch.bfloat16
            or w.dtype != (torch.uint8 if int4 else torch.int8)
            or scale.dtype != torch.float32
            or scale.shape != ((k // INT4_BLOCK, n) if int4 else (n,))
            or not all(t.device == x.device for t in (w, scale))):
        raise ValueError(f'{name}: x {tuple(x.shape)} {x.dtype}, w '
                         f'{tuple(w.shape)} {w.dtype}, scale '
                         f'{tuple(scale.shape)} {scale.dtype}; the kernel '
                         f'takes x (8, K) bf16, K % 256 == 0, K <= {MAX_K}, '
                         f'N % {N_MULTIPLE} == 0')
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    x, w, scale = x.contiguous(), w.contiguous(), scale.contiguous()
    if any(t.data_ptr() % 16 for t in (x, w, scale)):
        raise ValueError(f'{name}: the kernel takes 16-byte aligned tensors')
    from groma_tpu_torch.ops.cuda_lib import check, probe_library, stream_ptr
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = m8_plan('int4' if int4 else 'w8a8', k, n, sms)
    out = torch.empty((M, n), dtype=torch.float32, device=dev)
    xq = torch.empty((M, k), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    xsum = (torch.empty((k // XQ_CHUNK, M), dtype=torch.int32, device=dev)
            if int4 else None)
    partial = counters = None
    if plan['splits'] > 1:
        partial = torch.empty((plan['splits'], M, n),
                              dtype=torch.float32 if int4 else torch.int32,
                              device=dev)
        counters = quant4._tile_counters(dev, plan['col_tiles'])
    status = probe_library().groma_probe_m8_matmul(
        *[None if t is None else t.data_ptr()
          for t in (x, w, scale, out, xq, xs, xsum, partial, counters)],
        k, n, int(int4), plan['split_rows'], plan['splits'], stream_ptr(x))
    check(status, name)
    return out


def w8a8_matmul(x, wq, sc):
    """CPU tensors: the plain version.  CUDA tensors: x (8, K) bf16, wq
    (K, N) int8, sc (N,) f32, K a multiple of 256 up to 32768, N of 16;
    the hand-written kernels."""
    if x.device.type == 'cpu':
        return w8a8_reference(x, wq, sc)
    out = _launch('w8a8_matmul', x, wq, sc, False)
    w8a8_matmul.launches += 1
    return out


def int4_a8_matmul(x, packed, scale):
    """CPU tensors: the plain version.  CUDA tensors: x (8, K) bf16, packed
    (K/2, N) uint8, scale (K/256, N) f32, K a multiple of 256 up to 32768,
    N of 16; the hand-written kernels."""
    if x.device.type == 'cpu':
        return int4_a8_reference(x, packed, scale)
    out = _launch('int4_a8_matmul', x, packed, scale, True)
    int4_a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
int4_a8_matmul.launches = 0


def w8a8_library(x, wq, sc):
    """The w8a8 function through PyTorch's own calls: the plain quantizer,
    ``torch._int_mm`` on x padded to 32 rows, the scales."""
    xq, xs = act_quant(x)
    xp = torch.nn.functional.pad(xq, (0, 0, 0, INT_MM_ROWS - xq.shape[0]))
    acc = torch._int_mm(xp, wq)[:xq.shape[0]].to(torch.float32)
    return acc * xs[:, None] * sc[None, :]


def make_inputs(device, seed: int = 0):
    """The TPU probe's fixtures: x ~ 0.1 N(0, 1) bf16 and w ~ 0.02 N(0, 1)
    per shape, w quantized to int8 (per column) and int4 (256-row blocks),
    and kept in bf16.  -> (xs, weights f32, {form: weights})."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = {k: (torch.randn((M, kd), generator=gen, device=device) * 0.1).to(
        torch.bfloat16) for k, kd, _ in SHAPES}
    ws = {k: torch.randn((kd, n), generator=gen, device=device) * 0.02
          for k, kd, n in SHAPES}
    forms = {'bf16': {k: w.to(torch.bfloat16) for k, w in ws.items()},
             'int8': {k: quantize_weight(w) for k, w in ws.items()},
             'int4': {}}
    for k, w in ws.items():
        qd = quantize_weight_int4(w, block=INT4_BLOCK)
        forms['int4'][k] = (qd['q'], qd['scale'])
    return xs, ws, forms


def layer_bytes(form: str) -> int:
    """Bytes of one layer's four weight matrices and their scales."""
    if form == 'int4':
        return sum(kd * n // 2 + (kd // INT4_BLOCK) * n * 4
                   for _, kd, n in SHAPES)
    return sum(kd * n + 4 * n for _, kd, n in SHAPES)


def layer_bound(form: str):
    """(ms, by) of one layer's four matmuls at M=8 on one H100: weights,
    scales, x and out once; the operations at the int8 rate."""
    io = sum(M * kd * 2 + M * n * 4 for _, kd, n in SHAPES)
    ops = sum(2 * M * kd * n for _, kd, n in SHAPES)
    return bound(layer_bytes(form) + io, ops, H100_INT8_OPS)


def variants():
    """(name, per-shape function of (x, weights), weight form)."""
    return [('bf16 dot', lambda x, w: torch.matmul(x, w), 'bf16'),
            ('int8 kernel', lambda x, w: int8_matmul(x, *w), 'int8'),
            ('w8a8 xla', lambda x, w: w8a8_library(x, *w), 'int8'),
            ('w8a8 kernel', lambda x, w: w8a8_matmul(x, *w), 'int8'),
            ('int4 kernel', lambda x, w: int4_matmul(x, *w), 'int4'),
            ('int4-a8 kernel', lambda x, w: int4_a8_matmul(x, *w), 'int4')]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions on the host clock)")
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timer, label = timer_for(device)
    on_card = device.startswith('cuda')      # rates only from the card
    xs, ws, forms = make_inputs(device, args.seed)
    gflop = 2 * M * sum(kd * n for _, kd, n in SHAPES) / 1e9
    print(f'# per-layer matmul set: {gflop:.2f} GFLOP, int8 '
          f'{layer_bytes("int8") / 1e6:.0f} MB, int4 '
          f'{layer_bytes("int4") / 1e6:.0f} MB; x{L} layers; bound '
          f'{layer_bound("int8")[0] * L:.2f} ms (int8), '
          f'{layer_bound("int4")[0] * L:.2f} ms (int4) [{label}]',
          flush=True)

    ref = {k: xs[k].to(torch.float32) @ ws[k] for k, _, _ in SHAPES}
    for name, fn, form in variants():
        outs = [fn(xs[k], forms[form][k]) for k, _, _ in SHAPES]
        err = max(((o.float() - ref[k]).abs().max()
                   / ref[k].abs().max().clamp(min=1e-6)).item()
                  for (k, _, _), o in zip(SHAPES, outs))
        print(f'# relerr {name}: {err:.4f}', flush=True)

    for name, fn, form in variants():
        def layer(_fn=fn, _w=forms[form]):
            return [_fn(xs[k], _w[k]) for k, _, _ in SHAPES]
        ms = timer(layer)
        rate = f'{gflop / ms:6.1f} TF/s eff' if on_card else 'host clock'
        print(f'{name:16s}: {ms * L:7.2f} ms/{L}-layer step ({rate})',
              flush=True)


if __name__ == '__main__':
    main()
