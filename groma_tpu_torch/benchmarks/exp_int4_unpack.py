"""Which int4 nibble unpack should the M=8 decode tile use on the H100?

Counterpart of the TPU probe ``benchmarks/exp_int4_unpack.py`` (kernels
``_kern_a``, ``_kern_b``, ``_kern_c``), which timed one unpack + dot through
three integer lane widths of the TPU's vector unit.  On the card the three
variants are three unpacks, one hand-written kernel template in
``csrc/probe_int4_unpack.cu``, all computing

    out (8, N) f32 = x[:, :KH] @ (p & 0xF) + x[:, KH:] @ (p >> 4)

from x (8, 2 KH) bf16 and p (KH, N) uint8 (unsigned nibbles, no scale):

  A  byte-permute into the mantissa of 2^23, one FADD, f32 FMAs
  B  integer shift and mask, int-to-float, f32 FMAs
  C  lop3 to bf16 pairs, mma.sync m16n8k16 bf16, the weights as A and
     the batch of 8 as N

All three read the same feed, the one #7's decode tile runs: the packed
rows split by ``ops/quant4.decode_plan(2 KH, N, sms)`` (at least two tiles
a split), each CTA's 64-row
tiles of p and x's two matching boxes brought by TMA through a 4-stage
mbarrier ring, the splits summed in order by the last CTA of each column
tile.  So a variant's time is its unpack and dot, not its loads.  Each
variant's time and packed-weight rate at the TPU probe's strip (KH=2048,
N=512) and at #7's down_proj (KH=5504, N=4096), with #7's own
``int4_matmul`` at down_proj beside them (unit scales: a reference line,
not the same function).

* ``unpack_matmul_reference`` is the plain PyTorch version, on any device.
* ``unpack_matmul(x, p, variant)`` takes it only for CPU tensors; on CUDA
  tensors it launches the variant's kernel or raises;
  ``unpack_matmul.launches`` counts launches per variant.
* ``unpack_plan`` and ``unpack_stages`` give the launch's split and the
  tiles each CTA streams, in the kernel's order.

Run on the card: ``python -m groma_tpu_torch.benchmarks.exp_int4_unpack``
(``--device cpu`` runs the plain version on the host clock).
"""

from __future__ import annotations

import argparse

import torch

from groma_tpu_torch.checkpoint.loader import resolve_device
from groma_tpu_torch.ops.quant4 import (DECODE_TILE, _tile_counters,
                                        decode_plan, int4_matmul)
from groma_tpu_torch.utils.profiling import bound, timer_for

M = 8
KHALF, N = 2048, 512             # the TPU probe's strip
SHAPES = {'strip': (KHALF, N), 'down_proj': (5504, 4096)}   # (KH, N)
VARIANTS = {'A': 'A prmt into 2^23 + FMA     ',
            'B': 'B shift/mask + i2f + FMA   ',
            'C': 'C lop3 bf16 + mma.sync     '}
REFERENCE = '#7, scaled: not the same function'
TILE_ROWS, TILE_COLS = DECODE_TILE   # packed rows, columns of one TMA box
STAGES = 4                           # the kernel's ring
MIN_SPLIT_TILES = 2   # one-tile splits were slower at the strip (PR 21)
# dynamic shared memory of one CTA: alignment slack, the ring of (packed
# tile + x's two 8 x 64 bf16 boxes), its barriers
SMEM_BYTES = 1024 + STAGES * (TILE_ROWS * TILE_COLS + 2 * M * 64 * 2) \
    + 2 * STAGES * 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def unpack_matmul_reference(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x (M, 2 KH) @ the nibble planes of p (KH, N) -> (M, N) f32: an f32
    dot of x against each plane, as the TPU kernels' bf16 dots with f32
    sums."""
    kh = p.shape[0]
    pi = p.to(torch.int32)
    xf = x.to(torch.float32)
    return xf[:, :kh] @ (pi & 0xF).to(torch.float32) \
        + xf[:, kh:] @ (pi >> 4).to(torch.float32)


def unpack_plan(kh: int, n: int, sms: int) -> dict:
    """The launch for p (KH, N) on a card with ``sms`` SMs: #7's decode
    split of the packed rows (``split_rows`` a CTA, whole 64-row tiles, the
    last range shorter), with at least ``MIN_SPLIT_TILES`` tiles a split
    where KH has them (so a CTA's ring overlaps a load with a body, and the
    last CTA of a column tile adds half as many partial sums), ``col_tiles``
    CTAs of 128 columns per split, and each CTA's dynamic shared memory."""
    split_rows, _ = decode_plan(2 * kh, n, sms)
    tiles = kh // TILE_ROWS
    per = max(split_rows // TILE_ROWS, min(tiles, MIN_SPLIT_TILES))
    return {'split_rows': per * TILE_ROWS, 'splits': _cdiv(tiles, per),
            'col_tiles': _cdiv(n, TILE_COLS), 'smem': SMEM_BYTES}


def unpack_stages(kh: int, n: int, sms: int) -> list:
    """The packed rows of the tiles each split streams through its ring, in
    the kernel's order (each tile brings x at k = r and k = KH + r)."""
    plan = unpack_plan(kh, n, sms)
    rows = plan['split_rows']
    return [list(range(z * rows, min(kh, (z + 1) * rows), TILE_ROWS))
            for z in range(plan['splits'])]


def unpack_matmul(x: torch.Tensor, p: torch.Tensor,
                  variant: str = 'A') -> torch.Tensor:
    """CPU tensors: the plain version.  CUDA tensors: x (8, 2 KH) bf16, p
    (KH, N) uint8, KH a multiple of 64 and N of 64, both contiguous and
    16-byte aligned; the variant's kernel."""
    if x.device.type == 'cpu':
        return unpack_matmul_reference(x, p)
    kh, n = p.shape if p.dim() == 2 else (0, 0)
    if (variant not in VARIANTS or x.shape != (M, 2 * kh) or kh % TILE_ROWS
            or n % 64 or not kh or not n or x.dtype != torch.bfloat16
            or p.dtype != torch.uint8 or p.device != x.device
            or not x.is_contiguous() or not p.is_contiguous()
            or x.data_ptr() % 16 or p.data_ptr() % 16):
        raise ValueError(f'unpack_matmul: variant {variant}, x '
                         f'{tuple(x.shape)} {x.dtype}, p {tuple(p.shape)} '
                         f'{p.dtype}; the kernels take contiguous, 16-byte '
                         f'aligned x (8, 2 KH) bf16 and p (KH, N) uint8, '
                         f'KH % 64 == 0, N % 64 == 0')
    if x.device.type != 'cuda':
        raise ValueError(f'unpack_matmul: unsupported device {x.device}')
    from groma_tpu_torch.ops.cuda_lib import check, probe_library, stream_ptr
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = unpack_plan(kh, n, sms)
    out = torch.empty((M, n), dtype=torch.float32, device=x.device)
    partial = counters = None
    if plan['splits'] > 1:
        partial = torch.empty((plan['splits'], M, n), dtype=torch.float32,
                              device=x.device)
        counters = _tile_counters(x.device, plan['col_tiles'])
    status = probe_library().groma_probe_int4_unpack(
        x.data_ptr(), p.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        counters.data_ptr() if counters is not None else None, kh, n,
        'ABC'.index(variant), plan['split_rows'], plan['splits'],
        stream_ptr(x))
    check(status, 'unpack_matmul')
    unpack_matmul.launches[variant] += 1
    return out


unpack_matmul.launches = {v: 0 for v in VARIANTS}


def make_inputs(kh: int, n: int, device, seed: int = 0):
    """x (8, 2 KH) bf16 and p (KH, N) uint8 from ``seed``, made on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, 2 * kh), generator=gen, device=device).to(
        torch.bfloat16)
    p = torch.randint(0, 256, (kh, n), generator=gen, device=device,
                      dtype=torch.uint8)
    return x, p


def unpack_bound(kh: int, n: int):
    """(ms, by) on one H100: the packed bytes, x and out once; the dot's
    operations at the bf16 rate."""
    return bound(kh * n + M * 2 * kh * 2 + M * n * 4, 2 * M * 2 * kh * n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "version on the host clock)")
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timer, label = timer_for(device)
    on_card = device.startswith('cuda')      # rates only from the card
    print(f'# int4 unpack probe, M={M} [{label}]', flush=True)
    for shape, (kh, n) in SHAPES.items():
        x, p = make_inputs(kh, n, device, args.seed)
        bnd, by = unpack_bound(kh, n)
        print(f'# {shape} KH={kh} N={n}: {kh * n / 1e6:.1f} MB packed, '
              f'bound {bnd * 1e3:.1f} us ({by})', flush=True)
        timed = [(name, lambda v=v: unpack_matmul(x, p, v))
                 for v, name in VARIANTS.items()]
        if shape == 'down_proj':
            scale = torch.ones((2 * kh // 256, n), device=device)
            timed.append((REFERENCE, lambda: int4_matmul(x, p, scale)))
        for name, fn in timed:
            got = float(fn().float().sum())
            dt = timer(fn) / 1e3
            rate = (f'{kh * n / 1e9 / dt:6.0f} GB/s, '
                    f'{bnd / 1e3 / dt * 100:5.1f} % of the bound'
                    if on_card else 'host clock')
            print(f'{name} {shape}: {dt * 1e6:7.1f} us/strip  {rate} '
                  f'(sum={got:.1f})', flush=True)


if __name__ == '__main__':
    main()
