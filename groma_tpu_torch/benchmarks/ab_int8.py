"""Two trees of the port on the int8 served path, in one run on one card.

    python3 -m groma_tpu_torch.benchmarks.ab_int8 --trees OLD NEW NEW OLD

Each tree runs in its own process, through ``trees.run_trees``.  Each run
measures, at full Groma-7B width with random weights from ``--seed``:

* #1, ``int8_matmul``, the four layer matmuls at M = 1, 8 and 2048
  (device time, CUDA events, L2 flushed before each call:
  ``utils/profiling.Timer``, chip_smoke's timer);
* the served path (``ModelWorker``, int8 LLM, int8 KV cache): one request
  to warm up, ``--requests`` more (prefill ms and decode ms/token on the
  host clock), then one warm prefill alone and the same request with 9 new
  tokens under torch.profiler: the prefill's device time and its longest
  kernels, and the device time a decode token.

Needs a CUDA device: without one the child raises.
"""

from __future__ import annotations

import argparse

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


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs='+', help='checkout roots, in turns')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--requests', type=int, default=3)
    return ap


def child(timer, args) -> dict:
    import torch
    if timer is None:
        raise RuntimeError('ab_int8 measures on a CUDA device')
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.serve.worker import ModelWorker
    torch.backends.cuda.matmul.allow_tf32 = False
    seed, requests = args.seed, args.requests
    out = {'device': torch.cuda.get_device_name(0)}
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


def main(argv=None):
    from groma_tpu_torch.benchmarks.trees import card as card_name
    from groma_tpu_torch.benchmarks.trees import run_trees
    args = parser().parse_args(argv)
    card = card_name()
    print(card)
    results = run_trees(__file__, args.trees, [
        '--seed', str(args.seed), '--requests', str(args.requests)])
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
