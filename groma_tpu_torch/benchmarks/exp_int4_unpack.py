"""Which int4 nibble unpack should the M=8 decode tile use on the H100?

Counterpart of the TPU probe ``benchmarks/exp_int4_unpack.py`` (kernels
``_kern_a``, ``_kern_b``, ``_kern_c``), which timed one unpack + dot through
three integer lane widths of the TPU's vector unit.  On the card the three
variants are three unpacks, one hand-written kernel template in
``csrc/probe_int4_unpack.cu``, all computing

    out (8, N) f32 = x[:, :KH] @ (p & 0xF) + x[:, KH:] @ (p >> 4)

from x (8, 2 KH) bf16 and p (KH, N) uint8 (unsigned nibbles, no scale):

  A  byte-permute into the mantissa of 2^23, f32 FMAs (what #7 ships)
  B  integer shift and mask, int-to-float, f32 FMAs
  C  lop3 to bf16 pairs, mma.sync m16n8k16 bf16 (x's rows 8..15 zero)

Each variant's time and packed-weight rate at the TPU probe's strip
(KH=2048, N=512) and at #7's down_proj (KH=5504, N=4096).

* ``unpack_matmul_reference`` is the plain PyTorch version, on any device.
* ``unpack_matmul(x, p, variant)`` takes it only for CPU tensors; on CUDA
  tensors it launches the variant's kernel or raises;
  ``unpack_matmul.launches`` counts launches per variant.

Run on the card: ``python -m groma_tpu_torch.benchmarks.exp_int4_unpack``
(``--device cpu`` runs the plain version on the host clock).
"""

from __future__ import annotations

import argparse

import torch

from groma_tpu_torch.checkpoint.loader import resolve_device
from groma_tpu_torch.utils.profiling import bound, timer_for

M = 8
KHALF, N = 2048, 512             # the TPU probe's strip
SHAPES = {'strip': (KHALF, N), 'down_proj': (5504, 4096)}   # (KH, N)
VARIANTS = {'A': 'A prmt into 2^23 + FMA (#7)',
            'B': 'B shift/mask + i2f + FMA   ',
            'C': 'C lop3 bf16 + mma.sync     '}
_ROWS = 128                      # KH and the split chunks are multiples


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


def unpack_matmul(x: torch.Tensor, p: torch.Tensor,
                  variant: str = 'A') -> torch.Tensor:
    """CPU tensors: the plain version.  CUDA tensors: x (8, 2 KH) bf16, p
    (KH, N) uint8, KH a multiple of 128 and N of 64, both contiguous; the
    variant's kernel."""
    if x.device.type == 'cpu':
        return unpack_matmul_reference(x, p)
    if x.device.type != 'cuda':
        raise ValueError(f'unpack_matmul: unsupported device {x.device}')
    kh, n = p.shape
    if (variant not in VARIANTS or x.shape != (M, 2 * kh) or kh % _ROWS
            or n % 64 or x.dtype != torch.bfloat16 or p.dtype != torch.uint8
            or p.device != x.device):
        raise ValueError(f'unpack_matmul: variant {variant}, x '
                         f'{tuple(x.shape)} {x.dtype}, p {tuple(p.shape)} '
                         f'{p.dtype}; the kernels take x (8, 2 KH) bf16, p '
                         f'(KH, N) uint8, KH % 128 == 0, N % 64 == 0')
    from groma_tpu_torch.ops.cuda_lib import check, probe_library, stream_ptr
    x, p = x.contiguous(), p.contiguous()
    # split the packed rows until about two blocks run per SM
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = kh // _ROWS
    splits = max(1, min(_cdiv(2 * sms, n // 64), chunks))
    chunk = _cdiv(chunks, splits) * _ROWS
    splits = _cdiv(kh, chunk)
    out = torch.empty((M, n), dtype=torch.float32, device=x.device)
    status = probe_library().groma_probe_int4_unpack(
        x.data_ptr(), p.data_ptr(), out.data_ptr(), kh, n,
        'ABC'.index(variant), chunk, splits, stream_ptr(x))
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
        for v, name in VARIANTS.items():
            got = float(unpack_matmul(x, p, v).sum())
            dt = timer(lambda: unpack_matmul(x, p, v)) / 1e3
            rate = (f'{kh * n / 1e9 / dt:6.0f} GB/s' if on_card
                    else 'host clock')
            print(f'{name} {shape}: {dt * 1e6:7.1f} us/strip  {rate} '
                  f'(sum={got:.1f})', flush=True)


if __name__ == '__main__':
    main()
