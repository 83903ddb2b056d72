"""Two trees of the port on the int8 served path, in one run on one card.

    python3 groma_tpu_torch/benchmarks/ab_int8.py --trees OLD NEW NEW OLD

Each tree (a checkout's root) runs in its own process, with that tree's
``groma_tpu_torch`` first on the path and its kernels built there, in the
order given (give the two trees in turns: old, new, new, old).  Each run
measures, at full Groma-7B width with random weights from ``--seed``:

* #1, ``int8_matmul``, the four layer matmuls at M = 1, 8 and 2048
  (device time, CUDA events, L2 flushed before each call:
  ``utils/profiling.Timer``, chip_smoke's timer);
* the served path (``ModelWorker``, int8 LLM, int8 KV cache): one request
  to warm up, ``--requests`` more (prefill ms and decode ms/token on the
  host clock), then one warm prefill alone and the same request with 9 new
  tokens under torch.profiler: the prefill's device time and its longest
  kernels, and the device time a decode token.

Each run prints one JSON line; the parent prints them all and a table.
Needs a CUDA device: without one the child raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

LAYERS = {'qkv_proj': (4096, 12288), 'o_proj': (4096, 4096),
          'gate_up_proj': (4096, 22016), 'down_proj': (11008, 4096)}
PROMPTS = ('Locate the dog on the left in the image.',
           'What is in this picture? Give boxes for each object.',
           'Find the red car.')


def _image(seed: int, size: int):
    """chip_smoke's random image: normalized pixels from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.standard_normal((size, size, 3)).astype(np.float32)


def _profiled(torch, worker, image, prompt, new):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in worker.generate_stream({'image': image, 'prompt': prompt,
                                         'max_new_tokens': new}):
            pass
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA' and e.device_time > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return dict(worker.generator.last_stats), by_name


def child(seed: int, requests: int) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('ab_int8 measures on a CUDA device')
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.serve.worker import ModelWorker
    from groma_tpu_torch.utils.profiling import Timer
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {'tree': os.getcwd(), 'device': torch.cuda.get_device_name(0)}
    timer = Timer('cuda')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    for m in (1, 8, 2048):
        total = 0.0
        for k, n in LAYERS.values():
            x = torch.randn((m, k), generator=gen, device='cuda').to(
                torch.bfloat16)
            w = torch.randint(-127, 128, (k, n), generator=gen,
                              device='cuda', dtype=torch.int8)
            scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3 \
                + 1e-4
            total += timer(lambda: int8_matmul(x, w, scale))
        out[f'four_matmuls_ms_m{m}'] = total
    del timer
    torch.cuda.empty_cache()

    worker = ModelWorker('random', seed=seed, quant_type='int8', kv_bits=8,
                         device='cuda')
    size = worker.cfg.perceiver.image_size
    for _ in worker.generate_stream({'image': _image(seed, size),
                                     'prompt': PROMPTS[0],
                                     'max_new_tokens': 32}):
        pass
    prefill, decode = [], []
    for i in range(requests):
        for _ in worker.generate_stream({
                'image': _image(seed + 1 + i, size),
                'prompt': PROMPTS[i % len(PROMPTS)], 'max_new_tokens': 32}):
            pass
        stats = worker.generator.last_stats
        prefill.append(stats['prefill_ms'])
        decode.append(stats['decode_ms_per_token'])
    out['prefill_ms'] = prefill
    out['decode_ms_per_token'] = decode
    image = _image(seed + 1, size)
    pre_stats, by_name = _profiled(torch, worker, image, PROMPTS[0], 1)
    dec_stats, dec_names = _profiled(torch, worker, image, PROMPTS[0], 9)
    pre_dev = sum(by_name.values())
    out['profiled_prefill_ms'] = pre_stats['prefill_ms']
    out['prefill_device_ms'] = pre_dev
    out['prefill_top'] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    fwd = dec_stats['decode_forwards']
    out['decode_forwards'] = fwd
    out['decode_device_ms_per_token'] = (
        (sum(dec_names.values()) - pre_dev) / fwd if fwd else None)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs='+', help='checkout roots, in turns')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--child', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.seed, args.requests)), flush=True)
        return
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    results = []
    for tree in args.trees:
        root = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--child', '--seed',
             str(args.seed), '--requests', str(args.requests)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f'ab_int8: the run of {tree} failed:\n'
                     f'{proc.stdout[-4000:]}{proc.stderr[-4000:]}')
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res['tree'] = tree
        results.append(res)
        print(json.dumps(res), flush=True)
    for r in results:
        print(f"{r['tree']:>24}: four matmuls M=1 "
              f"{r['four_matmuls_ms_m1']:.4f} ms, M=8 "
              f"{r['four_matmuls_ms_m8']:.4f}, M=2048 "
              f"{r['four_matmuls_ms_m2048']:.4f}; prefill "
              f"{', '.join(f'{v:.1f}' for v in r['prefill_ms'])} ms (warm "
              f"profiled {r['profiled_prefill_ms']:.1f}, device "
              f"{r['prefill_device_ms']:.2f}); decode "
              f"{', '.join(f'{v:.2f}' for v in r['decode_ms_per_token'])} "
              f"ms/token, device {r['decode_device_ms_per_token']} ms a "
              f"token [{card}]")


if __name__ == '__main__':
    main()
