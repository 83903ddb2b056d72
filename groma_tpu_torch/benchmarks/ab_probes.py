"""Two trees of the port on the H100 probes #10 and #12, on one card.

    python3 -m groma_tpu_torch.benchmarks.ab_probes --trees OLD NEW NEW OLD

Each tree runs in its own process, through ``trees.run_trees``.  Each run
measures, with inputs from ``--seed``, through the tree's wrappers:

* #10, ``unpack_matmul``, every variant at the probe's two shapes (the
  strip, KH=2048, N=512, and down_proj, KH=5504, N=4096);
* #12, ``probe_decode_attention``, every variant of the probe's list on
  one layer (B=8, H=32, S=1024; the ``Lstack`` rows on two layers, per
  layer);
* a PyTorch read of the same bytes (a sum over #10's packed weights, over
  one layer's K and V viewed as f32): what a plain streaming read takes.

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
    from groma_tpu_torch.benchmarks import exp_int4_unpack as unpack
    if timer is None:
        raise RuntimeError('ab_probes needs a CUDA device')
    out = {'device': torch.cuda.get_device_name(0)}

    def both(name, fn, per=1):
        out[name] = [timer(fn, 20, clean=c) / per for c in (False, True)]

    for shape, (kh, n) in unpack.SHAPES.items():
        x, p = unpack.make_inputs(kh, n, 'cuda', args.seed)
        for v in unpack.VARIANTS:
            both(f'#10 {v} {shape}',
                 lambda v=v: unpack.unpack_matmul(x, p, v))
        pw = p.view(torch.float32)
        both(f'read {shape} packed', lambda: pw.sum())
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


if __name__ == '__main__':
    main()
