"""Do int8 tensor cores beat weight streaming for the M=8 decode matmul?

Counterpart of the TPU probe ``benchmarks/exp_decode_matmul_m8.py``
(kernels ``_w8a8_kernel`` and ``_int4_a8_kernel``).  The four 7B layer
matmuls (qkv 4096x12288, o 4096x4096, gate_up 4096x22016, down 11008x4096)
at M=8, summed and scaled to a 32-layer step, through:

  bf16 dot          torch.matmul on bf16 weights (a library yardstick)
  int8 kernel       the port's int8_matmul (#1, weight streaming)
  w8a8 xla          per-row int8 activation quant, then torch._int_mm (x
                    padded to 32 rows: it takes M > 16), then the scales
  w8a8 kernel       the same in hand-written CUDA: the int8 products on
                    mma.sync m16n8k32 s8 (``csrc/probe_decode_matmul_m8.cu``)
  int4 kernel       the port's int4_matmul (#7, bf16-plane weight streaming)
  int4-a8 kernel    biased nibble planes as int8 on the same tensor cores,
                    per 256-row scale block, minus 8 sum(xq)

* ``act_quant``, ``w8a8_reference`` and ``int4_a8_reference`` are the plain
  PyTorch versions, on any device (integer dots in f64, where they are
  exact; the TPU kernels' order of f32 operations).
* ``w8a8_matmul`` and ``int4_a8_matmul`` take them only for CPU tensors; on
  CUDA tensors they launch their kernel or raise; ``<wrapper>.launches``
  counts calls (each runs three kernels: quantizer, product, epilogue).

Run on the card: ``python -m groma_tpu_torch.benchmarks.exp_decode_matmul_m8``
(``--device cpu`` runs the plain versions on the host clock).
"""

from __future__ import annotations

import argparse

import torch

from groma_tpu_torch.checkpoint.loader import resolve_device
from groma_tpu_torch.ops.quant import (int8_matmul, quantize_weight,
                                       true_div)
from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, int4_matmul,
                                        quantize_weight_int4)
from groma_tpu_torch.utils.profiling import H100_INT8_OPS, bound, timer_for

D, F = 4096, 11008
SHAPES = [('qkv', D, 3 * D), ('o', D, D), ('gu', D, 2 * F), ('down', F, D)]
M = 8
L = 32
_SEG = 128          # weight rows a chunk of the kernel
INT_MM_ROWS = 32    # torch._int_mm takes more than 16 rows


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


def _launch(name, x, w, scale, int4: bool):
    from groma_tpu_torch.ops.cuda_lib import check, probe_library, stream_ptr
    m, k = x.shape
    n = w.shape[1]
    rows = k // 2 if int4 else k
    if (m != M or k % INT4_BLOCK or n % 64 or w.shape[0] != rows
            or x.dtype != torch.bfloat16
            or w.dtype != (torch.uint8 if int4 else torch.int8)
            or scale.dtype != torch.float32
            or scale.shape != ((k // INT4_BLOCK, n) if int4 else (n,))
            or not all(t.device == x.device for t in (w, scale))):
        raise ValueError(f'{name}: x {tuple(x.shape)} {x.dtype}, w '
                         f'{tuple(w.shape)} {w.dtype}, scale '
                         f'{tuple(scale.shape)}; the kernel takes x (8, K) '
                         f'bf16, K % 256 == 0, N % 64 == 0')
    x, w, scale = x.contiguous(), w.contiguous(), scale.contiguous()
    dev = x.device
    # split the weight rows until about two blocks (of 4 warps) run per SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = rows // _SEG
    splits = max(1, min(_cdiv(2 * sms, n // 64), _cdiv(chunks, 4)))
    per_split = _cdiv(chunks, splits)
    splits = _cdiv(chunks, per_split)
    out = torch.empty((M, n), dtype=torch.float32, device=dev)
    xq = torch.empty((M, k), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    xsum = torch.empty((M, k // _SEG), dtype=torch.int32, device=dev)
    acc = torch.empty((M, n), dtype=torch.float32, device=dev)
    status = probe_library().groma_probe_m8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), xsum.data_ptr(), acc.data_ptr(), k, n,
        int(int4), per_split, splits, stream_ptr(x))
    check(status, name)
    return out


def w8a8_matmul(x, wq, sc):
    """CPU tensors: the plain version.  CUDA tensors: x (8, K) bf16, wq
    (K, N) int8, sc (N,) f32; the hand-written kernel."""
    if x.device.type == 'cpu':
        return w8a8_reference(x, wq, sc)
    if x.device.type != 'cuda':
        raise ValueError(f'w8a8_matmul: unsupported device {x.device}')
    out = _launch('w8a8_matmul', x, wq, sc, False)
    w8a8_matmul.launches += 1
    return out


def int4_a8_matmul(x, packed, scale):
    """CPU tensors: the plain version.  CUDA tensors: x (8, K) bf16, packed
    (K/2, N) uint8, scale (K/256, N) f32; the hand-written kernel."""
    if x.device.type == 'cpu':
        return int4_a8_reference(x, packed, scale)
    if x.device.type != 'cuda':
        raise ValueError(f'int4_a8_matmul: unsupported device {x.device}')
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
