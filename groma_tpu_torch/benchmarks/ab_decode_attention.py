"""Two trees of the port on the decode-attention kernels, on one card.

    python3 -m groma_tpu_torch.benchmarks.ab_decode_attention \\
        --trees OLD NEW NEW OLD [--fence NEW]

Each tree runs in its own process, through ``trees.run_trees``.  Each run
measures, at full Groma-7B width with random inputs and weights from
``--seed``:

* #2, ``int8_decode_attention``, and #8, ``paged_int8_decode_attention``,
  through the tree's wrappers at chip_smoke's cases: #2 at B=1, S=2112 with
  a valid prefix of 2048 slots and with the served stream's own mask (the
  worker's template of a chip_smoke prompt, expanded, plus 32 decoded
  slots), at B=8, S=1024 with the per-layer path's 512-576 kept slots, and
  at B=4, S=2112 with a valid prefix; #8 at chip_smoke's PAGED_LENGTHS and
  at the engine's lengths (8 rows of 400-600 tokens, 19-page tables).
  Device time from CUDA events, with the L2 flushed before each call and
  without;
* where the tree's wrappers take a cluster size (``plan=`` / ``cluster=``),
  #2 at the two B=1 cases and #8 at PAGED_LENGTHS for C = 1, 2, 4 and 8;
* the timer's floor: one launch of a one-element kernel; the host's time
  a wrapper call (200 calls behind a sleep kernel, host clock) for #2 at
  the served mask and #8 at the engine's lengths;
* the served path (``ModelWorker``, int8 LLM, int8 KV cache): one warm
  prefill alone and the same request with 9 new tokens under
  torch.profiler: the device time a decode token;
* the engine (``--engine --quant_type int4 --kv-bits 8 --paged-kv``, 8
  slots): 8 concurrent requests, two decode bursts with every slot live
  under torch.profiler: the device time a decode step.

``--fence TREE`` adds, to that tree's first run, #7's two tiles (the
four layer matmuls on the int4 decode tile at M = 1 and 8, on the prefill
tile at M = 2048) and #9 (the decode megakernel at full width, 2 layers,
B=8), with the tree's kernels and with a copy of them built without
``fence.proxy.async`` before ring stages are released, in turns.

Device times from ``utils/profiling.Timer`` (median of 20).  Needs a CUDA
device: without one the child raises.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess

PROMPT = 'Locate the dog on the left in the image.'
PAGED_LENGTHS = (2432, 2301, 1900, 1500, 1024, 700, 129, 0)
ENGINE_LENGTHS = (400, 430, 460, 490, 520, 550, 580, 600)
LAYERS4 = {'qkv_proj': (4096, 12288), 'o_proj': (4096, 4096),
           'gate_up_proj': (4096, 22016), 'down_proj': (11008, 4096)}


def _image(seed: int, size: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.standard_normal((size, size, 3)).astype(np.float32)


def _host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``, enqueued behind a sleep kernel
    so that the device never holds the host back."""
    import time
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def _served_valid(torch, s: int, decoded: int):
    """The served stream's kept slots at a decode step, as the worker
    expands a request (every tree has these data modules)."""
    from groma_tpu_torch.config import GromaConfig
    from groma_tpu_torch.data.conversation import conv_templates
    from groma_tpu_torch.data.datasets.base import intro_conversation
    from groma_tpu_torch.data.tokenization import expand_template
    from groma_tpu_torch.data.tokenizer import StubTokenizer
    cfg = GromaConfig()
    tok = StubTokenizer(cfg.llm.vocab_size, cfg.max_seq_len)
    conv = conv_templates.get('llava')
    messages = intro_conversation(conv)
    messages += [(conv.roles[0], PROMPT), (conv.roles[1], None)]
    t = expand_template(tok.encode(conv.get_prompt(messages)), None, tok.sp,
                        cfg.num_image_tokens, cfg.max_region_num,
                        cfg.max_seq_len)
    valid = torch.zeros(s, dtype=torch.bool)
    valid[:cfg.max_seq_len] = torch.from_numpy(t['valid'])
    valid[cfg.max_seq_len:cfg.max_seq_len + decoded] = True
    return valid


def _attention(torch, gen, timer, out):
    from groma_tpu_torch.models.llama_quant import _quantize_tokens
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.paged_attention import (
        PAGE, paged_int8_decode_attention)
    h, d, dev = 32, 128, 'cuda'
    prefix = torch.arange(2112)[None] < 2048
    cases = {'#2 near-dense B=1 S=2112': prefix,
             '#2 served mask B=1 S=2112': _served_valid(torch, 2112, 32)[None],
             '#2 per-layer B=8 S=1024': torch.arange(1024)[None]
             < torch.tensor([512 + 8 * i for i in range(8)])[:, None],
             '#2 near-dense B=4 S=2112': prefix.repeat(4, 1)}
    sweep = 'plan' in inspect.signature(int8_decode_attention).parameters
    for name, valid in cases.items():
        b, s = valid.shape
        q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k8, ks = _quantize_tokens(torch.randn((b, h, s, d), generator=gen,
                                              device=dev))
        v8, vs = _quantize_tokens(torch.randn((b, h, s, d), generator=gen,
                                              device=dev))
        bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].to(dev)
        args = (q, k8, ks, v8, vs, bias.contiguous())
        out[name] = [timer(lambda: int8_decode_attention(*args), 20, f)
                     for f in (True, False)]
        out[name + ' kept'] = int(valid.sum())
        if 'served' in name:
            out[name + ' host us/call'] = _host_us(
                torch, lambda: int8_decode_attention(*args))
        if sweep and b == 1:
            from groma_tpu_torch.ops.decode_attention import (
                decode_attention_plan)
            stages = decode_attention_plan(
                b, h, s, torch.cuda.get_device_properties(0)
                .multi_processor_count)[1]
            for c in (1, 2, 4, 8):
                out[f'{name} C={c}'] = [timer(
                    lambda: int8_decode_attention(*args, plan=(c, stages)),
                    20, f) for f in (True, False)]
    pool = 160
    for name, lengths, np_ in (('#8 chip_smoke lengths', PAGED_LENGTHS, 19),
                               ('#8 engine lengths', ENGINE_LENGTHS, 19)):
        b = len(lengths)
        k8, ks = _quantize_tokens(torch.randn((pool, h, PAGE, d),
                                              generator=gen, device=dev))
        v8, vs = _quantize_tokens(torch.randn((pool, h, PAGE, d),
                                              generator=gen, device=dev))
        ids = (torch.randperm(pool - 1, generator=gen, device=dev)
               + 1).tolist()
        table = torch.zeros((b, np_), dtype=torch.int32)
        for row, n in enumerate(lengths):
            used = -(-n // PAGE)
            if used:
                table[row, :used] = torch.tensor(ids[:used])
                table[row, used:] = ids[used - 1]
                ids = ids[used:]
        q = torch.randn((b, h, 1, d), generator=gen, device=dev)
        args = (q, k8, ks, v8, vs, table.to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        out[name] = [timer(lambda: paged_int8_decode_attention(*args), 20,
                           f) for f in (True, False)]
        if lengths == ENGINE_LENGTHS:
            out[name + ' host us/call'] = _host_us(
                torch, lambda: paged_int8_decode_attention(*args))
        if sweep and lengths == PAGED_LENGTHS:
            for c in (1, 2, 4, 8):
                out[f'{name} C={c}'] = [timer(
                    lambda: paged_int8_decode_attention(*args, cluster=c),
                    20, f) for f in (True, False)]
    one = torch.zeros(1, device=dev)
    out['timer floor'] = [timer(one.zero_, 20, f) for f in (True, False)]


def _device_ms(torch, fn):
    """(fn's result, {kernel: device ms}) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA' and e.device_time > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return res, by_name


def _served(torch, seed, out):
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('random', seed=seed, quant_type='int8', kv_bits=8,
                         device='cuda')
    image = _image(seed + 1, worker.cfg.perceiver.image_size)

    def request(new):
        def run():
            for _ in worker.generate_stream({'image': image, 'prompt': PROMPT,
                                             'max_new_tokens': new}):
                pass
            return dict(worker.generator.last_stats)
        return run
    request(32)()                                     # warm
    _, pre = _device_ms(torch, request(1))
    stats, dec = _device_ms(torch, request(9))
    fwd = stats['decode_forwards']
    out['served decode device ms/token'] = (
        (sum(dec.values()) - sum(pre.values())) / fwd if fwd else None)
    out['served attention device ms/token'] = (
        (sum(v for k, v in dec.items() if 'decode_attention' in k)
         - sum(v for k, v in pre.items() if 'decode_attention' in k)) / fwd
        if fwd else None)
    del worker


def _engine(torch, seed, out):
    import threading
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('random', seed=seed, quant_type='int4', kv_bits=8,
                         device='cuda', use_engine=True, engine_slots=8,
                         paged_kv=True)
    engine = worker.engine
    burst = engine._decode_burst
    profiled = []

    def profiled_burst():
        if len(profiled) >= 2 or not engine._active.all():
            return burst()
        steps0 = engine._n_steps
        _, names = _device_ms(torch, burst)
        profiled.append((engine._n_steps - steps0, names))
    engine._decode_burst = profiled_burst

    def client(i):
        for _ in worker.generate_stream({
                'image': _image(100 + i, worker.cfg.perceiver.image_size),
                'prompt': 'Find the red car.', 'max_new_tokens': 32,
                'stream_chunk': 1}):
            pass
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(engine.max_slots)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    engine._decode_burst = burst
    n = sum(p[0] for p in profiled)
    total = sum(sum(p[1].values()) for p in profiled)
    paged = sum(v for p in profiled for k, v in p[1].items()
                if 'paged_attention' in k)
    out['engine device ms/step'] = total / n if n else None
    out['engine paged attention device ms/step'] = paged / n if n else None
    del worker


def _fence(torch, gen, timer, out):
    """#7's tiles and #9 with the tree's kernels and without the fence."""
    import ctypes
    import shutil
    import tempfile
    from groma_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from groma_tpu_torch.models.llama_quant import (megakernel_step_inputs,
                                                    quantize_llama_params)
    from groma_tpu_torch.ops import cuda_lib
    from groma_tpu_torch.ops import decode_megakernel as mk
    from groma_tpu_torch.ops.quant4 import int4_matmul
    fenced = cuda_lib.library()
    tmp = tempfile.mkdtemp(dir=str(cuda_lib.BUILD_DIR))
    shutil.copytree(cuda_lib.CSRC, f'{tmp}/csrc',
                    ignore=shutil.ignore_patterns('build'))
    for name in ('int4_matmul.cu', 'decode_megakernel.cu'):
        path = f'{tmp}/csrc/{name}'
        with open(path) as fh:
            src = fh.read()
        with open(path, 'w') as fh:
            fh.write(src.replace('sm90::fence_proxy_async();', ''))
    objs = []
    for src in cuda_lib.sources():
        obj = f'{tmp}/{src.stem}.o'
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, '-c',
                        f'{tmp}/csrc/{src.name}', '-o', obj], check=True,
                       capture_output=True)
        objs.append(obj)
    subprocess.run([cuda_lib._nvcc(), '-shared', '-o', f'{tmp}/lib.so',
                    *objs], check=True, capture_output=True)
    unfenced = ctypes.CDLL(f'{tmp}/lib.so')
    cuda_lib._declare(unfenced)
    libs = {'fence': fenced, 'no fence': unfenced}

    cfg = LlamaConfig(num_layers=2)
    torch.manual_seed(0)
    with torch.no_grad():
        llm = LlamaForCausalLM(cfg, device='cuda')
        qp = quantize_llama_params(llm.state_dict(), cfg, bits=4)
        del llm
    lp = qp['layers'][0]
    cases = {}
    for m in (1, 8, 2048):
        xs = {key: torch.randn((m, lp[key]['q'].shape[0] * 2), generator=gen,
                               device='cuda').to(torch.bfloat16)
              for key in LAYERS4}

        def four(xs=xs):
            for key, x in xs.items():
                int4_matmul(x, lp[key]['q'], lp[key]['scale'])
        cases[f'#7 four layer matmuls M={m}'] = four
    sp = mk.stack_decode_params(qp)
    b, s, pos = 8, 1024, 700
    cache = {'k': [], 'v': [], 'k_scale': [], 'v_scale': []}
    for _ in range(cfg.num_layers):
        for key in ('k', 'v'):
            cache[key].append(torch.randint(-127, 128, (b, 32, s, 128),
                                            generator=gen, device='cuda',
                                            dtype=torch.int8))
            cache[key + '_scale'].append(torch.rand(
                (b, 32, s), generator=gen, device='cuda') * 0.02 + 0.005)
    cache['mask'] = torch.arange(s, device='cuda')[None].repeat(b, 1) < pos
    cache['index'] = pos
    st = mk.stack_kv_cache(cache)
    x = torch.randn((b, cfg.hidden_size), generator=gen, device='cuda')
    inputs = megakernel_step_inputs(cfg, cache, torch.ones(
        (b, 1), dtype=torch.bool, device='cuda'))
    cases['#9 megakernel 2 layers B=8'] = lambda: mk.fused_decode_step(
        sp, x, st, *inputs, pos, eps=cfg.rms_norm_eps)
    with torch.no_grad():
        for name, fn in cases.items():
            row = []
            for key in ('fence', 'no fence', 'no fence', 'fence'):
                cuda_lib._lib = libs[key]
                row.append([key, timer(fn, 20)])
            out[name] = row
    cuda_lib._lib = fenced


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs='+', help='checkout roots, in turns')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--fence', metavar='TREE',
                    help='time #7 and #9 with and without the stage fence '
                         "in this tree's first run")
    return ap


def child(timer, args) -> dict:
    import torch
    if timer is None:
        raise RuntimeError('ab_decode_attention measures on a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = args.seed
    out = {'device': torch.cuda.get_device_name(0)}
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    _attention(torch, gen, timer, out)
    if args.fence:
        _fence(torch, gen, timer, out)
    torch.cuda.empty_cache()
    _served(torch, seed, out)
    torch.cuda.empty_cache()
    _engine(torch, seed, out)
    return out


def main(argv=None):
    import os
    from groma_tpu_torch.benchmarks.trees import card as card_name
    from groma_tpu_torch.benchmarks.trees import run_trees
    args = parser().parse_args(argv)
    card = card_name()
    print(card)
    fence = [os.path.abspath(args.fence)] if args.fence else []

    def argv_for(root):
        first = root in fence          # the fence tree's first run only
        if first:
            fence.remove(root)
        return ['--seed', str(args.seed), *(['--fence', root] if first
                                            else [])]
    results = run_trees(__file__, args.trees, argv_for)
    for r in results:
        times = ', '.join(f'{k} {v[0]:.4f} ({v[1]:.4f} warm)'
                          for k, v in r.items()
                          if k.startswith('#') and isinstance(v, list)
                          and not isinstance(v[0], list))
        print(f"{r['tree']:>24}: {times} ms; served "
              f"{r['served decode device ms/token']} ms of device time a "
              f"token (attention {r['served attention device ms/token']}); "
              f"engine {r['engine device ms/step']} ms a step (paged "
              f"attention {r['engine paged attention device ms/step']}) "
              f"[{card}]")


if __name__ == '__main__':
    main()
