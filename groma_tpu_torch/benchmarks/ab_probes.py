"""Two trees of the port on the H100 probes #10, #11 and #12, on one card.

    python3 -m groma_tpu_torch.benchmarks.ab_probes --trees OLD NEW NEW OLD

Each tree runs in its own process, through ``trees.run_trees``.  Each run
measures, with inputs from ``--seed``, through the tree's wrappers:

* #10, ``unpack_matmul``, every variant at the probe's two shapes (the
  strip, KH=2048, N=512, and down_proj, KH=5504, N=4096);
* #11, ``w8a8_matmul`` and ``int4_a8_matmul`` at the four 7B layer
  matmuls (M=8), each shape and their sum; beside them ``w8a8_library``
  whole (the plain quantizer, ``torch._int_mm`` on x padded to 32 rows,
  the scales) and ``torch._int_mm`` alone, and #1's and #7's M=8 decode
  tiles on the same weights; and each variant's split of one call from
  torch.profiler (``Timer.split``: the quantizer's and the product's
  device time, anything else the call launches, launches a call);
* #12, ``probe_decode_attention``, every variant of the probe's list on
  one layer (B=8, H=32, S=1024; the ``Lstack`` rows on two layers, per
  layer);
* a PyTorch read of the same bytes (a sum over #10's packed weights, over
  #11's int8 and packed int4 weights, over one layer's K and V viewed as
  f32): what a plain streaming read takes.

Device time from ``utils/profiling.Timer`` (median of 20), with the L2
flushed before each call in two ways: by writing 128 MB, as chip_smoke
does (the call then writes back up to 50 MB of dirty lines as it reads),
and by reading them (``clean=True``: the call finds clean lines).  Needs a
CUDA device: without one the child raises.
"""

from __future__ import annotations

import argparse


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs='+', help='checkout roots, in turns')
    ap.add_argument('--seed', type=int, default=0)
    return ap


def child(timer, args) -> dict:
    import torch
    from groma_tpu_torch.benchmarks import exp_decode_attn_variants as attn
    from groma_tpu_torch.benchmarks import exp_decode_matmul_m8 as m8
    from groma_tpu_torch.benchmarks import exp_int4_unpack as unpack
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.ops.quant4 import int4_matmul
    if timer is None:
        raise RuntimeError('ab_probes needs a CUDA device')
    out = {'device': torch.cuda.get_device_name(0)}

    def both(name, fn, per=1):
        out[name] = [timer(fn, 20, clean=c) / per for c in (False, True)]
        return out[name]

    for shape, (kh, n) in unpack.SHAPES.items():
        x, p = unpack.make_inputs(kh, n, 'cuda', args.seed)
        for v in unpack.VARIANTS:
            both(f'#10 {v} {shape}',
                 lambda v=v: unpack.unpack_matmul(x, p, v))
        pw = p.view(torch.float32)
        both(f'read {shape} packed', lambda: pw.sum())
    # #11: each shape, then the four summed (the sum of the shapes' medians)
    xs, _, forms = m8.make_inputs('cuda', args.seed)
    padded = {k: torch.nn.functional.pad(
        m8.act_quant(xs[k])[0], (0, 0, 0, m8.INT_MM_ROWS - m8.M))
        for k, _, _ in m8.SHAPES}
    rows = [('#11 w8a8', m8.w8a8_matmul, 'int8'),
            ('#11 int4-a8', m8.int4_a8_matmul, 'int4'),
            ('w8a8_library whole', m8.w8a8_library, 'int8'),
            ('torch._int_mm alone (x padded)', None, 'int8'),
            ('#1 int8_matmul M=8', int8_matmul, 'int8'),
            ('#7 int4_matmul M=8', int4_matmul, 'int4'),
            ('read int8 weights', None, 'int8'),
            ('read int4 packed + scales', None, 'int4')]
    for name, fn, form in rows:
        total = [0.0, 0.0]
        for k, _, _ in m8.SHAPES:
            w = forms[form][k]
            if name.startswith('torch._int_mm'):
                call = (lambda p=padded[k], wq=w[0]: torch._int_mm(p, wq))
            elif name.startswith('read'):
                views = [t.view(torch.float32) for t in w]
                call = (lambda v=views: [t.sum() for t in v])
            else:
                call = (lambda f=fn, x=xs[k], w=w: f(x, *w))
            ms = both(f'{name} {k}', call)
            total = [a + b for a, b in zip(total, ms)]
        out[f'{name}, the 4 matmuls'] = total
    for name, fn, form in rows[:2]:
        out[f'split {name}'] = timer.split(
            lambda f=fn, w=forms[form]: [
                f(xs[k], *w[k]) for k, _, _ in m8.SHAPES],
            per=len(m8.SHAPES))
    del xs, forms, padded

    q, k8, ks, v8, vs, bias = attn.make_inputs(2, 'cuda', args.seed)
    for name, body, hb, sblk, stacked in attn.variants():
        if stacked:
            both(f'#12 {name} (per layer of 2)', lambda v=(body, hb, sblk):
                 attn.probe_decode_attention(q, k8, ks, v8, vs, bias, *v),
                 per=2)
        else:
            both(f'#12 {name}', lambda v=(body, hb, sblk):
                 attn.probe_decode_attention(q, k8[0], ks[0], v8[0], vs[0],
                                             bias, *v))
    kw, vw = k8[0].view(torch.float32), v8[0].view(torch.float32)
    both('read one layer of KV', lambda: (kw.sum(), vw.sum()))
    return out


def main(argv=None):
    from groma_tpu_torch.benchmarks.trees import card, run_trees
    args = parser().parse_args(argv)
    name = card()
    print(name)
    runs = run_trees(__file__, args.trees, ['--seed', str(args.seed)])
    print(f'# ms, L2 flushed by writing / by reading [{name}]')
    keys = list(dict.fromkeys(k for r in runs for k in r
                              if isinstance(r[k], list)))
    print(f'{"":38s}' + ''.join(f'{r["tree"][-18:]:>20s}' for r in runs))
    for k in keys:
        cells = ''.join(
            f'{r[k][0]:9.4f} /{r[k][1]:8.4f} ' if k in r else f'{"-":>20s}'
            for r in runs)
        print(f'{k:38s}{cells}')
    print('# the four layer matmuls under torch.profiler (L2 flushed by '
          'writing before each): device ms of the quantizer / the product / '
          'the rest, and device operations a wrapper call')
    for k in dict.fromkeys(k for r in runs for k in r if k.startswith('split')):
        cells = ''.join(
            f'{r[k]["quantizer"]:.4f}/{r[k]["product"]:.4f}/'
            f'{r[k]["other"]:.4f} x{r[k]["launches"]:g}  ' if k in r else '-'
            for r in runs)
        print(f'{k:38s}{cells}')


if __name__ == '__main__':
    main()
