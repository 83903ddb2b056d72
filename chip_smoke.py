#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (groma_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py [--seed N]

Phases, each printed before the last line:
 1. the card's name and power limit (nvidia-smi), then the nvcc build of
    every kernel in groma_tpu_torch/csrc (seconds, ptxas summary);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes the served path gives it, with the tolerance stated; kernel and
    plain times from CUDA events, L2 flushed before each launch; then the
    int8 LLaMA path at full width and two layers on the card against the
    same weights and inputs through the plain versions on the CPU;
 3. the served path at full Groma-7B width (GromaConfig defaults: DINOv2-L
    at 448, DDETR with 300 queries, 100 region slots, Vicuna-7B width, int8
    LLM, int8 KV cache, max_len = max_seq_len + 64) with random weights
    from --seed: the port's ModelWorker answers 3 requests in-process, each
    checked, and both kernels' launch counters must grow by exactly the
    count the main path implies.
Then one JSON line with the kernels, and as the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero and prints
no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

INT8_MATMUL_SHAPES = {          # (K, N) of every decode matmul at 7B width
    'qkv_proj': (4096, 12288),
    'o_proj': (4096, 4096),
    'gate_up_proj': (4096, 22016),
    'down_proj': (11008, 4096),
    'lm_head (padded to 512)': (4096, 32256),
    'lm_head (ragged N)': (4096, 32114),
}
LAYER_MATMULS = ('qkv_proj', 'o_proj', 'gate_up_proj', 'down_proj')
MAX_NEW_TOKENS = 32        # the 2112-slot cache leaves 64 after prefill


def fail(msg: str):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


class Timer:
    """Device time of one call, from CUDA events, averaged over ``iters``
    calls.  Before each call the L2 cache is overwritten (decode streams
    every weight and cache byte cold) and the stream is held by a sleep
    kernel, so the host's enqueue time is not counted."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def check_int8_matmul(torch, gen, timer, card):
    from groma_tpu_torch.ops.quant import int8_matmul, int8_matmul_reference
    dev = 'cuda'
    worst = 0.0
    layer_ms = {1: [0.0, 0.0]}
    for m in (1, 4):
        for name, (k, n) in INT8_MATMUL_SHAPES.items():
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            scale = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4
            got = int8_matmul(x, w, scale).float()
            want = int8_matmul_reference(x, w, scale).float()
            err = (got - want).abs()
            # fp32 sums in another order, then one bf16 rounding each: at
            # most one bf16 step (2^-7 relative) apart, plus f32 noise
            tol = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
            max_err = err.max().item()
            worst = max(worst, max_err)
            ms = timer(lambda: int8_matmul(x, w, scale))
            plain_ms = timer(lambda: int8_matmul_reference(x, w, scale))
            if m == 1 and name in LAYER_MATMULS:
                layer_ms[1][0] += ms
                layer_ms[1][1] += plain_ms
            ref_max = want.abs().max().item()
            print(f'int8_matmul M={m} {name} K={k} N={n}: max_abs_err '
                  f'{max_err:.3e}, rel {max_err / ref_max:.3e} of max|plain| '
                  f'{ref_max:.3e} (tol 2^-7*|plain| + 1e-4*max|plain|) '
                  f'{"ok" if ok else "FAIL"}; kernel {ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, '
                  f'{k * n / ms / 1e6:.1f} GB/s weights [{card}]')
            if not ok:
                fail(f'int8_matmul disagrees with its plain version at '
                     f'M={m} {name}')
    return worst, layer_ms[1]


def check_decode_attention(torch, gen, timer, card):
    from groma_tpu_torch.models.llama_quant import _quantize_tokens
    from groma_tpu_torch.ops.decode_attention import (
        int8_decode_attention, int8_decode_attention_reference, p8_step)
    dev = 'cuda'
    worst = 0.0
    served = None
    for b in (1, 4):
        for s in (1024, 2112):
            h, d = 32, 128
            q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(
                torch.bfloat16)
            k8, ks = _quantize_tokens(
                torch.randn((b, h, s, d), generator=gen, device=dev))
            v8, vs = _quantize_tokens(
                torch.randn((b, h, s, d), generator=gen, device=dev))
            # a valid prefix per row, the tail masked as unwritten slots
            valid = torch.arange(s, device=dev)[None] < torch.tensor(
                [s - 64 - 17 * i for i in range(b)], device=dev)[:, None]
            bias = torch.where(valid, 0.0, -1e30)[:, None, None, :]
            args = (q, k8, ks, v8, vs, bias.contiguous())
            got = int8_decode_attention(*args)
            want = int8_decode_attention_reference(*args)
            err = (got - want).abs()
            max_err = err.max().item()
            # the kernel's f32 exp and sums may differ from torch's in the
            # last bit, so a requantized p on a .5 tie may round the other
            # way: allow two such units per row, plus f32 noise
            step = p8_step(q, k8, ks, vs, args[-1])
            tol = 2 * step + 1e-5 * want.abs().max()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
            units = (err / step).max().item()
            worst = max(worst, max_err)
            ms = timer(lambda: int8_decode_attention(*args))
            plain_ms = timer(lambda: int8_decode_attention_reference(*args))
            if b == 1 and s == 2112:
                served = (ms, plain_ms)
            kv_bytes = 2 * b * h * s * d
            ref_max = want.abs().max().item()
            print(f'int8_decode_attention B={b} H={h} S={s} D={d}: '
                  f'max_abs_err {max_err:.3e}, rel {max_err / ref_max:.3e} '
                  f'of max|plain| {ref_max:.3e}, {units:.3f} p8 units (tol '
                  f'2 units + 1e-5*max|plain|) '
                  f'{"ok" if ok else "FAIL"}; kernel {ms:.4f} ms,'
                  f' plain {plain_ms:.4f} ms, '
                  f'{kv_bytes / ms / 1e6:.1f} GB/s KV [{card}]')
            if not ok:
                fail(f'int8_decode_attention disagrees with its plain '
                     f'version at B={b} S={s}')
    return worst, served


def check_llm_path(torch, seed: int, card: str):
    """The int8 LLaMA path at full width and two layers, on the card (the
    kernels) against the same weights and inputs on the CPU (the plain
    versions): prefill into an int8 KV cache, then decode steps."""
    from groma_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_forward,
                                                    quantize_llama_params)
    cfg = LlamaConfig(num_layers=2)           # Vicuna-7B width, bf16
    torch.manual_seed(seed)
    with torch.no_grad():
        llm = LlamaForCausalLM(cfg, device='cuda')
        qp = quantize_llama_params(llm.state_dict(), cfg)
        del llm
    b, s, steps = 2, 200, 4     # prefill M = 400 rows: dequant + matmul
    gen = torch.Generator().manual_seed(seed)
    emb = torch.randn((b, s, cfg.hidden_size), generator=gen)
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[1, 150:] = False
    pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
    steps_in = [torch.randn((b, 1, cfg.hidden_size), generator=gen)
                for _ in range(steps)]

    def run(device):
        tree = {k: v for k, v in qp.items()}
        move = lambda t: t.to(device)          # noqa: E731
        tree['layers'] = [{k: ({kk: move(vv) for kk, vv in v.items()}
                               if isinstance(v, dict) else move(v))
                           for k, v in lp.items()} for lp in qp['layers']]
        tree['norm'] = move(qp['norm'])
        cache = make_quant_kv_cache(cfg, b, s + steps, device=device)
        outs = []
        h, cache = quant_llama_forward(tree, cfg, move(emb), move(valid),
                                       move(pos), cache)
        outs.append(h.float().cpu())
        for i, x in enumerate(steps_in):
            h, cache = quant_llama_forward(
                tree, cfg, move(x), move(torch.ones((b, 1), dtype=bool)),
                move(pos[:, -1:] + 1 + i), cache)
            outs.append(h.float().cpu())
        return outs

    with torch.no_grad():
        got, want = run('cuda'), run('cpu')
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        # bf16 activations rounded at other points by other summation
        # orders: 3 % of the largest hidden value
        err = (g - w).abs().max().item() / w.abs().max().item()
        worst = max(worst, err)
        if not (err <= 3e-2 and torch.isfinite(g).all()):
            fail(f'int8 LLaMA path: {"prefill" if i == 0 else "decode"} '
                 f'step {i} differs from the CPU plain path by {err:.3e}')
    print(f'int8 LLaMA path, full width, 2 layers, B={b}: prefill {s} '
          f'tokens + {steps} decode steps on the card match the CPU plain '
          f'path within {worst:.3e} x max|hidden| (tol 3e-2) [{card}]')


def random_image(np, seed: int, size: int):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((size, size, 3)).astype(np.float32)


def serve_full_width(torch, np, seed: int, card: str):
    """Three requests through the port's ModelWorker at full width."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.serve.worker import ModelWorker

    t0 = time.perf_counter()
    worker = ModelWorker('random', seed=seed, quant_type='int8', kv_bits=8,
                         device='cuda')
    cfg = worker.cfg
    torch.cuda.synchronize()
    print(f'served path: random full-width Groma-7B built in '
          f'{time.perf_counter() - t0:.1f} s; device memory '
          f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    n_layers = cfg.llm.num_layers
    vocab = cfg.vocab_size
    prompts = ('Locate the dog on the left in the image.',
               'What is in this picture? Give boxes for each object.',
               'Find the red car.')
    int8_matmul.launches = 0
    int8_decode_attention.launches = 0
    for i, prompt in enumerate(prompts):
        image = random_image(np, seed + 1 + i, cfg.perceiver.image_size)
        request = {'image': image, 'prompt': prompt,
                   'max_new_tokens': MAX_NEW_TOKENS}
        before = int8_matmul.launches, int8_decode_attention.launches
        frames = list(worker.generate_stream(request))
        torch.cuda.synchronize()
        mm = int8_matmul.launches - before[0]
        att = int8_decode_attention.launches - before[1]
        final = frames[-1]
        if any(f['error_code'] != 0 for f in frames):
            fail(f'request {i}: error frame {final}')
        stats = worker.generator.last_stats
        f_fwd = stats['decode_forwards']
        want_mm = 1 + f_fwd * (4 * n_layers + 1)
        want_att = f_fwd * n_layers
        toks = stats['tokens']
        problems = []
        if mm != want_mm or att != want_att:
            problems.append(f'launches int8_matmul {mm} (want {want_mm}), '
                            f'decode attention {att} (want {want_att})')
        if not ((toks >= 0) & (toks < vocab)).all():
            problems.append('token out of vocabulary range')
        if not stats['logits_finite']:
            problems.append('non-finite logits')
        boxes = stats['selected_boxes'][0]
        mask = stats['selected_mask'][0]
        kept = boxes[mask]
        if not mask.any() or not np.isfinite(boxes).all() or not (
                (kept[:, 2:] > 0).all() and (kept >= 0).all()
                and (kept <= 1).all()):
            problems.append('malformed selected boxes')
        if any(not (np.isfinite(b).all() and len(b) == 4)
               for b in final['boxes']):
            problems.append('malformed boxes in the answer')
        if problems:
            fail(f'request {i}: ' + '; '.join(problems))
        print(f'request {i}: error_code 0, {toks.shape[1]} tokens, '
              f'{len(final["boxes"])} boxes in the answer, '
              f'{int(mask.sum())} regions kept; prefill '
              f'{stats["prefill_ms"]:.1f} ms, decode '
              f'{stats["decode_ms_per_token"]:.2f} ms/token over '
              f'{f_fwd} forwards; launches int8_matmul {mm}, decode '
              f'attention {att} [{card}]')
    return int8_matmul.launches, int8_decode_attention.launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights and inputs')
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: this script runs only on the GPU')
    try:
        from groma_tpu_torch.ops import cuda_lib
    except ImportError as e:
        fail(f'groma_tpu_torch not importable ({e}): run from the root of '
             f'the repository')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    print(card)
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'(nvcc {cuda_lib.build_info["seconds"]:.1f} s) -> '
          f'{cuda_lib.build_info["path"]}')
    for line in cuda_lib.build_info['log'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print(f'  ptxas: {line.strip()}')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(args.seed)
    timer = Timer(torch, 'cuda')
    mm_err, mm_ms = check_int8_matmul(torch, gen, timer, card)
    att_err, att_ms = check_decode_attention(torch, gen, timer, card)
    del timer
    check_llm_path(torch, args.seed, card)
    torch.cuda.empty_cache()

    mm_n, att_n = serve_full_width(torch, np, args.seed, card)
    if not (mm_n and att_n):
        fail('a kernel of the served path was never launched')
    if 'jax' in sys.modules or 'flax' in sys.modules:
        fail('jax was imported')

    print(json.dumps({'kernels': [
        {'name': 'int8_matmul', 'route': 'cuda',
         'source': 'groma_tpu_torch/csrc/int8_matmul.cu',
         'replaces': 'groma_tpu/ops/quant.py:52',
         'launches': mm_n, 'max_abs_err': mm_err,
         'ms': mm_ms[0], 'plain_ms': mm_ms[1]},
        {'name': 'int8_decode_attention', 'route': 'cuda',
         'source': 'groma_tpu_torch/csrc/decode_attention.cu',
         'replaces': 'groma_tpu/ops/decode_attention.py:32',
         'launches': att_n, 'max_abs_err': att_err,
         'ms': att_ms[0], 'plain_ms': att_ms[1]},
    ]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
