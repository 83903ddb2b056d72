#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (groma_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py [--seed N]

Phases, each printed before the last line:
 1. the card's name and power limit (nvidia-smi), then the nvcc builds of
    the two kernel libraries of groma_tpu_torch/csrc, side by side: the
    production kernels and the probes' csrc/probe_*.cu (seconds, ptxas
    summary);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes its path gives it, with the tolerance stated; kernel and plain
    times from CUDA events, L2 flushed before each launch, beside the
    kernel's bound (the larger of its bytes over 3.35 TB/s and its
    operations over the peak rate of their type) and the time of one
    PyTorch call that computes the same function where there is one
    (torch._weight_int8pack_mm / _weight_int4pack_mm, the SDPA forward and
    backward, torch._int_mm, the backend named): the int8 decode
    matmul and decode attention (served path), the packed-int4 matmul (each
    of the int4 tree's five shapes at M=1 and M=8, the engine's decode,
    and at M=2048, a prefill; at down_proj the bound is also shown to flag
    a wrong scale on the block that straddles K/2) and the paged decode
    attention (8 slots, ragged lengths up to 2432, shuffled
    pages, a frozen row), the flash-attention forward (bidirectional at the
    ViT's (2, 16, 1025, 64), causal at the LLM's (2, 32, 2048, 128) under a
    grounded key mask), the backward (bidirectional at the ViT's shape
    under a grounded key mask, also with a fully masked row and at
    Sq != Skv; causal at the LLM's and at S=1500; each called twice, dk and
    dv bitwise equal, and #5 and #6 with their TFLOP/s, share of the bound
    and ratio to SDPA's backward), the probes' kernels (#10-#12, every
    variant at the probes' shapes), and the all-layer decode
    megakernel at full width and 2 layers (B=8, a 1024-slot cache written
    at slot 700, a ragged mask and a fully masked row: the hidden state,
    the written column within one int8 unit, every other cache byte
    unchanged); then the int8 LLaMA path
    and the int4 + paged one (prefill, page compaction, paged decode) at
    full width and two layers on the card against the same weights and
    inputs through the plain versions on the CPU;
 3. stage-3 training (LLM trained) at full width and 2 LLM layers (108 GB
    of f32 Adam state at full depth does not fit one card): one step's
    loss and trainable gradients on the card against the same weights and
    batch through the plain versions on the CPU, in f32;
 4. the training path: stage 2 (scripts/vl_pretrain.sh: perceiver and LLM
    frozen) at full Groma-7B width and depth (GromaConfig defaults), random
    f32 weights from --seed, B=2 (reduced from 16 for memory), S=2048, a
    synthetic grounded batch (train/synthetic.py: the data pipeline's
    expand_template + collate_vl, ground boxes, labels) through the port's
    train_vl functions (random_groma_full,
    make_adamw on the warmup-cosine schedule, make_vl_train_step):
    TRAIN_STEPS steps, each printing loss, ms and peak memory and adding
    exactly one bidirectional forward launch per ViT layer and one causal
    forward and backward launch per LLM layer; frozen parameters must stay
    bitwise unchanged and every trainable one must change; then two more
    steps under torch.profiler: device busy share and the kernels that
    take the most device time;
 5. the served path at full Groma-7B width (DINOv2-L at 448, DDETR with
    300 queries, 100 region slots, Vicuna-7B width, int8 LLM, int8 KV
    cache, max_len = max_seq_len + 64) with random weights from --seed: the
    port's ModelWorker answers 3 requests in-process, each checked, and
    both int8 kernels' launch counters must grow by exactly the count the
    path implies;
 6. the production server at full width (--engine --engine-slots 8
    --quant_type int4 --kv-bits 8 --paged-kv, max_len 2432): the port's
    ModelWorker answers ENGINE_REQUESTS requests sent from as many threads
    at once, each checked; then every request finished, none truncated,
    every page back in the pool, and exact launch counts (paged attention
    L per decode step, int4 matmul 4L + 1 per prefill and per step), with
    TTFT per request, aggregate tok/s and ms per decode step;
 7. the decode benchmark's path (bench_decode_quant.measure_megakernel) at
    full depth: the random full-width Vicuna-7B int4 tree from --seed,
    B=8, a 512-token random prompt prefilled per layer into a 1024-slot
    int8 cache, MEGAKERNEL_STEPS greedy steps through
    quant_llama_decode_megakernel (exactly one megakernel launch each),
    then the same tokens teacher-forced through the per-layer
    quant_llama_forward on a copy of the cache (int4 matmul 4L and decode
    attention L launches a step); hidden states agree every step; ms/step
    and tok/s of both, PROFILED_STEPS more steps of each under
    torch.profiler (device time and operations a step), and the kernel
    alone beside its plain version and its bound.
 8. DINOv2-L at full width (24 layers, 448², B=2, bf16 on f32 master
    weights) forward and backward through the port's Dinov2Model with
    use_flash=True, the path of the bidirectional backward (#6): exactly
    24 launches of its forward and of its backward, and the parameter
    gradient of a fixed scalar against the same model with use_flash=False
    on the card;
 9. the H100 probes #10-#12 (groma_tpu_torch/benchmarks; each kernel
    variant was held against its plain version in phase 2): each probe's
    entry point as `python -m groma_tpu_torch.benchmarks.<name>` runs it,
    printing the probe's table.
Then one JSON line with the seventeen kernels (launches: the training
path's for the forward flash kernels and the causal backward, the DINOv2-L
phase's for the bidirectional backward, the served path's for the int8
ones, the engine's for the int4 and paged ones, the decode path's for the
megakernel, the probes' entry points' for theirs), and as the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero and prints
no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time

try:
    from groma_tpu_torch.utils.profiling import H100_INT8_OPS, Timer, bound
except ImportError as e:
    sys.exit(f'chip_smoke FAILED: groma_tpu_torch not importable ({e}): run '
             f'from the root of the repository')

INT8_MATMUL_SHAPES = {          # (K, N) of every decode matmul at 7B width
    'qkv_proj': (4096, 12288),
    'o_proj': (4096, 4096),
    'gate_up_proj': (4096, 22016),
    'down_proj': (11008, 4096),
    'lm_head (padded to 512)': (4096, 32256),
    'lm_head (ragged N)': (4096, 32114),
}
LAYER_MATMULS = ('qkv_proj', 'o_proj', 'gate_up_proj', 'down_proj')
INT4_MATMUL_SHAPES = {          # (K, N) of the int4 tree's matmuls
    'qkv_proj': (4096, 12288),
    'o_proj': (4096, 4096),
    'gate_up_proj': (4096, 22016),
    'down_proj': (11008, 4096),     # scale block 21 straddles K/2
    'lm_head (padded to 512)': (4096, 32256),
}
INT4_PREFILL_ROWS = 2048        # M of a prefill: one stream of max_seq_len
# the paged kernel at the engine's shapes: 8 slots, 32 heads of 128, a
# 160-page pool, ragged lengths up to max_len = 2432 (19 pages), one frozen
PAGED_LENGTHS = (2432, 2301, 1900, 1500, 1024, 700, 129, 0)
PAGED_POOL_PAGES = 160
ENGINE_REQUESTS = 12       # through 8 slots: 4 wait and join mid-decode
ENGINE_MAX_NEW = 32
MAX_NEW_TOKENS = 32        # the 2112-slot cache leaves 64 after prefill
TRAIN_BATCH = 2            # vl_pretrain.sh's 16 does not fit one card
TRAIN_STEPS = 4            # >= 2: the warmup-cosine schedule's lr is 0 first
# stage 3, card (bf16 activations, the kernels) against CPU (f32, plain):
# measured on an H100 at most 2.6e-5 (loss), 1.4e-2 (whole gradient) and
# 3.8e-2 (the region encoder's 1024-channel bf16 convs); the limits are
# about four times the loss's and twice the gradients'
STAGE3_LOSS_TOL = 1e-4     # relative
STAGE3_GRAD_TOL = 3e-2     # relative Frobenius error, all trainable grads
STAGE3_TENSOR_TOL = 8e-2   # the same, per gradient tensor
# the all-layer decode megakernel (#9): (a) at full width, 2 stacked layers,
# against its plain version; (b) the decode benchmark's path at full depth
# (bench_decode_quant.measure_megakernel: B=8, a 512-token prompt into a
# 1024-slot int8 cache), MEGAKERNEL_STEPS greedy steps (128 there, cut for
# time) against the per-layer decode teacher-forced on the same tokens
DECODE_BATCH, DECODE_PROMPT, DECODE_SLOTS = 8, 512, 1024
MEGAKERNEL_POS = 700       # (a): the slot written, of DECODE_SLOTS
MEGAKERNEL_STEPS = 64
PROFILED_STEPS = 4         # each decode path, under torch.profiler
# kernel against plain: f32 sums in another order flip a bf16 rounding of
# h, attn or act, or an int8 k/v byte, now and then; measured on an H100
# 5.2e-4 (hidden), 1.0e-3 (scales), ~0.5 % of the written bytes at 2
# layers, and at most 1.2e-3 (hidden), 2.1e-4 (scales) and 0.01 % of the
# bytes for any one of the path's 32 layers fed the same input: limits
# about four times that.  Over 32 layers the step is chaotic under
# rounding (the run prints how far the plain step moves when its input
# moves by 1e-6 relative), and the one 32-layer launch parts from the plain
# step by 8.6e-3, with 22 % of its written bytes off: it is held to
# MEGAKERNEL_DEPTH_TOL and an unchanged cache outside the written column.
# Megakernel path against the per-layer one (f32 against a bf16 residual
# over 32 layers): measured 3.5e-2, limit 0.1
MEGAKERNEL_HIDDEN_TOL = 5e-3     # relative to max|hidden|
MEGAKERNEL_SCALE_TOL = 1e-2      # written k/v scales, relative
MEGAKERNEL_DEPTH_TOL = 3e-2      # (b): one launch of all 32 layers
MEGAKERNEL_PATH_TOL = 0.1        # (b): relative to max|hidden|, every step
# DINOv2-L forward + backward (#6's path): the parameter gradient with the
# flash kernels (p and ds rounded to bf16) against the plain attention
# (bf16 scores, f32 softmax) on the card, relative Frobenius error;
# measured on an H100 1.15e-2 (whole gradient) and 0.100 (worst tensor, a
# layer-22 query bias): limits about three times that
VIT_BATCH = 2
VIT_RUNS = 4               # per path; the first is not timed
VIT_GRAD_TOL = 4e-2        # all parameters
VIT_TENSOR_TOL = 0.3       # per tensor, the key biases aside
# the probes' kernels: (TPU kernel, name, source, TPU file:line)
PROBE_KERNELS = [
    ('_kern_a', 'int4 unpack probe A', 'probe_int4_unpack.cu',
     'benchmarks/exp_int4_unpack.py:38'),
    ('_kern_b', 'int4 unpack probe B', 'probe_int4_unpack.cu',
     'benchmarks/exp_int4_unpack.py:50'),
    ('_kern_c', 'int4 unpack probe C', 'probe_int4_unpack.cu',
     'benchmarks/exp_int4_unpack.py:62'),
    ('_w8a8_kernel', 'M=8 probe w8a8', 'probe_decode_matmul_m8.cu',
     'benchmarks/exp_decode_matmul_m8.py:72'),
    ('_int4_a8_kernel', 'M=8 probe int4-a8', 'probe_decode_matmul_m8.cu',
     'benchmarks/exp_decode_matmul_m8.py:94'),
    ('k_floor', 'decode attn probe floor hb1', 'probe_decode_attn.cu',
     'benchmarks/exp_decode_attn_variants.py:51'),
    ('k_mxu', 'decode attn probe mxu hb1', 'probe_decode_attn.cu',
     'benchmarks/exp_decode_attn_variants.py:63'),
    ('k_mxu_sblk', 'decode attn probe mxu hb1 sb256', 'probe_decode_attn.cu',
     'benchmarks/exp_decode_attn_variants.py:89'),
]


def fail(msg: str):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def library_time(torch, timer, name: str, fn, want, card: str,
                 rel_tol: float = 1e-2):
    """ms of one PyTorch call that computes what a kernel computes (a
    yardstick: the port never calls it), once it has agreed with the plain
    result within ``rel_tol`` of max|plain|; None, with the reason, where
    the installed PyTorch has no such call or it computes something else."""
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError, TypeError,
            ValueError) as e:
        first = (str(e).splitlines() or [''])[0][:140]
        print(f'  library {name}: none ({type(e).__name__}: {first}) '
              f'[{card}]')
        return None
    pairs = list(zip(got, want)) if isinstance(want, (tuple, list)) \
        else [(got, want)]
    rel = max((g.float() - w.float()).abs().max().item()
              / w.float().abs().max().item() for g, w in pairs)
    if not rel <= rel_tol:
        print(f'  library {name}: none (differs from the plain version by '
              f'{rel:.3e} of max|plain|) [{card}]')
        return None
    ms = timer(fn)
    print(f'  library {name}: {ms:.4f} ms, within {rel:.2e} of max|plain| '
          f'[{card}]')
    return ms


def kernel_names(torch, fn, top: int = 3) -> str:
    """The CUDA kernels one call of ``fn`` launches, longest first (which
    backend a PyTorch call picked)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA':
            names[e.name] = names.get(e.name, 0.0) + e.device_time
    return ', '.join(n[:60] for n, _ in sorted(names.items(),
                                               key=lambda kv: -kv[1])[:top])


def check_int8_matmul(torch, gen, timer, card):
    """#1 against its plain version.  Returns (max_abs_err, (kernel ms,
    plain ms), (bound ms, bound by), library ms), the sums over the four
    layer matmuls at M=1."""
    from groma_tpu_torch.ops.quant import int8_matmul, int8_matmul_reference
    dev = 'cuda'
    worst = 0.0
    layer_ms = {1: [0.0, 0.0]}
    layer_bound, bound_by, library = 0.0, '', 0.0
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
                b_ms, bound_by = bound(k * n + 4 * n + 2 * m * (k + n),
                                       2 * m * k * n)
                layer_bound += b_ms
                if library is not None:
                    # bf16 scales (the plain version's are f32)
                    w_t = w.T.contiguous()
                    t = library_time(
                        torch, timer, f'torch._weight_int8pack_mm {name}',
                        lambda: torch._weight_int8pack_mm(
                            x, w_t, scale.to(torch.bfloat16)), want, card)
                    library = None if t is None else library + t
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
    return worst, layer_ms[1], (layer_bound, bound_by), library


def check_decode_attention(torch, gen, timer, card):
    """#2 against its plain version.  Returns (max_abs_err, (kernel ms,
    plain ms), (bound ms, bound by)) at the served shape, B=1 and S=2112
    (no PyTorch call computes int8-KV attention with p requantized)."""
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
            kv_bytes = 2 * b * h * s * d
            if b == 1 and s == 2112:
                served = ((ms, plain_ms), bound(
                    kv_bytes + 2 * b * h * s * 4 + b * h * d * (2 + 4)
                    + b * s * 4, 4 * b * h * s * d, H100_INT8_OPS))
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
    return (worst, *served)


def _flash_tol(want, rel: float):
    """Per element: rel x |plain| + rel x max|plain| / 4."""
    return rel * want.abs() + 0.25 * rel * want.abs().max()


def _grounded_key_mask(b: int, s: int):
    """(B, S) numpy bool: per row a gap in the middle (unused region slots)
    and a ragged padded tail."""
    import numpy as np
    mask = np.ones((b, s), bool)
    for i in range(b):
        lo = s // 4 + 7 * i
        mask[i, lo:lo + s // 5] = False
        mask[i, s - 13 - 11 * i:] = False
    return mask


def _grad_errors(torch, got, want, card):
    """(worst max_abs_err, largest max|plain|, ok) of (dq, dk, dv) against
    their plain versions: p and ds are rounded to bf16 before their products
    and the results are bf16, so 2^-6 of |plain| + 2^-8 of max|plain| per
    gradient, and finite."""
    worst, ref_max, ok = 0.0, 0.0, True
    for name, g_, w_ in zip(('dq', 'dk', 'dv'), got, want):
        e = (g_.float() - w_).abs()
        ok &= bool((e <= _flash_tol(w_, 2.0 ** -6)).all())
        ok &= bool(torch.isfinite(g_).all())
        rel = e.max().item() / w_.abs().max().item()
        print(f'  {name}: max_abs_err {e.max().item():.3e}, rel {rel:.3e} '
              f'of max|plain| {w_.abs().max().item():.3e} [{card}]')
        worst = max(worst, e.max().item())
        ref_max = max(ref_max, w_.abs().max().item())
    return worst, ref_max, ok


def _bwd_repeat(torch, name, call, got, want, card):
    """A second call of the backward on the same inputs: dk and dv bitwise
    equal to the first (one CTA per key tile, the query tiles in a fixed
    order), dq within the same limit of the plain version (its f32 parts
    are added in an order that varies from run to run)."""
    again = call()
    same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    dq_ok = bool(((again[0].float() - want[0]).abs()
                  <= _flash_tol(want[0], 2.0 ** -6)).all())
    moved = (again[0].float() - got[0].float()).abs().max().item()
    print(f'  {name} called twice: dk, dv bitwise equal {same}; dq moved by '
          f'{moved:.3e}, within 2^-6*|plain| + 2^-8*max|plain| {dq_ok} '
          f'[{card}]')
    if not (same and dq_ok):
        fail(f'{name}: a second call changed dk/dv or put dq out of limits')


def _bwd_rate(name, flops, ms, bnd, lib, card):
    """#5's or #6's rate, share of its bound and ratio to SDPA, a line
    each."""
    print(f'  {name} rate: {flops / ms / 1e9:.1f} TFLOP/s [{card}]')
    print(f'  {name} share of bound: {100 * bnd[0] / ms:.1f} % of its '
          f'{bnd[0]:.4f} ms ({bnd[1]}) [{card}]')
    print(f'  {name} against SDPA backward: '
          + (f'{ms / lib:.3f} x its {lib:.4f} ms' if lib else 'no SDPA time')
          + f' [{card}]')


def check_flash(torch, gen, timer, card):
    """The three flash kernels against their plain versions in f32 on the
    same bf16 inputs, at the training path's shapes, and the same
    functions through F.scaled_dot_product_attention (the backend it picks
    named).  Returns {kernel: (max_abs_err, ms, plain_ms, (bound ms, bound
    by), library ms)} at the path's own mask."""
    import torch.nn.functional as F
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_bwd, flash_fwd, mha_reference)
    from groma_tpu_torch.train.synthetic import (grounded_batch,
                                                 grounded_kv_mask)
    dev = 'cuda'
    results = {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def report(name, shape, case, err, ref_max, tol_txt, ok, ms, plain_ms,
               flops):
        print(f'{name} {shape} {case}: max_abs_err {err:.3e}, rel '
              f'{err / max(ref_max, 1e-30):.3e} of max|plain| '
              f'{ref_max:.3e} (tol {tol_txt}) {"ok" if ok else "FAIL"}; '
              f'kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain '
              f'{plain_ms:.4f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s) '
              f'[{card}]')
        if not ok:
            fail(f'{name} disagrees with its plain version: {case}')

    # bf16 out (2^-9) from bf16-rounded p: 2^-7 of |plain| + 2^-9 of max
    fwd_rel = 2.0 ** -7
    # --- #3: the ViT's bidirectional whole-kv forward, (2, 16, 1025, 64)
    b, h, s, d = 2, 16, 1025, 64
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    masks = {'all keys valid': torch.ones((b, s), dtype=torch.bool,
                                          device=dev)}
    m = torch.ones((b, s), dtype=torch.bool, device=dev)
    m[0, 700:] = False                        # a masked tail
    m[1] = False                              # every key masked
    masks['row 0 tail masked, row 1 all masked'] = m
    for case, mask in masks.items():
        got, glse = flash_fwd(q, k, v, mask, False, d ** -0.5)
        want, wlse = mha_reference(q.float(), k.float(), v.float(), mask,
                                   False, d ** -0.5)
        err = (got.float() - want).abs()
        ok = bool((err <= _flash_tol(want, fwd_rel)).all())
        ok &= bool((glse - wlse).abs().max() <= 1e-3)
        if case != 'all keys valid':
            ok &= bool((got[1] == 0).all()) and bool((glse[1] == -1e30).all())
        ms = timer(lambda: flash_fwd(q, k, v, mask, False, d ** -0.5,
                                     need_lse=False))
        plain_ms = timer(lambda: mha_reference(q, k, v, mask, False,
                                               d ** -0.5))
        report('flash_fwd bidirectional (#3)', (b, h, s, d), case,
               err.max().item(), want.abs().max().item(),
               f'2^-7*|plain| + 2^-9*max|plain|, lse 1e-3', ok, ms, plain_ms,
               4 * b * h * s * s * d)
        if case == 'all keys valid':
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, scale=d ** -0.5)
            lib = library_time(torch, timer, 'F.scaled_dot_product_attention'
                               ' (#3, no mask)', sdpa, want, card)
            print(f'  its kernels: {kernel_names(torch, sdpa)} [{card}]')
            results['bidirectional'] = (
                err.max().item(), ms, plain_ms,
                bound(4 * b * h * s * d * 2 + b * s, 4 * b * h * s * s * d),
                lib)
        del got, want

    # --- #6: the bidirectional backward at the ViT's shape, from the plain
    # forward's out and lse; a grounded key mask (a gap and a ragged tail
    # per row), then row 1 fully masked (its gradients must be exactly 0)
    do = rand(b, h, s, d)
    grounded = torch.from_numpy(_grounded_key_mask(b, s)).to(dev)
    dead = grounded.clone()
    dead[1] = False
    bwd_flops = 2.5 * 4 * b * h * s * s * d
    for case, mask in (('grounded key mask', grounded),
                       ('grounded key mask, row 1 all masked', dead)):
        want_out, lse = mha_reference(q.float(), k.float(), v.float(), mask,
                                      False, d ** -0.5)
        out = want_out.to(torch.bfloat16)
        got = flash_bwd(q, k, v, mask, out, lse, do, False, d ** -0.5)
        want = flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), mask, out.float(), lse,
            do.float(), False, d ** -0.5)
        worst, ref_max, ok = _grad_errors(torch, got, want, card)
        if mask is dead:
            ok &= all(bool((g_[1] == 0).all()) for g_ in got)
        ms = timer(lambda: flash_bwd(q, k, v, mask, out, lse, do, False,
                                     d ** -0.5))
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q, k, v, mask, out, lse, do, False, d ** -0.5))
        if case == 'grounded key mask':
            # SDPA's autograd backward under the same boolean mask
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask[:, None, None, :], scale=d ** -0.5)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                sdpa_out, leaves, do, retain_graph=True)
            lib = library_time(torch, timer, 'F.scaled_dot_product_attention '
                               'backward (#6, key mask)', sdpa_bwd, want,
                               card, rel_tol=3e-2)
            print(f'  its kernels: {kernel_names(torch, sdpa_bwd)} [{card}]')
            del sdpa_out, leaves
            results['bidirectional backward'] = (
                worst, ms, plain_ms,
                bound(8 * b * h * s * d * 2 + b * h * s * 4 + b * s,
                      bwd_flops), lib)
            _bwd_repeat(torch, 'flash_bwd bidirectional (#6)',
                        lambda: flash_bwd(q, k, v, mask, out, lse, do, False,
                                          d ** -0.5), got, want, card)
        report('flash_bwd bidirectional (#6)', (b, h, s, d), case, worst,
               ref_max, '2^-6*|plain| + 2^-8*max|plain| per gradient'
               + (', row 1 exactly 0' if mask is dead else ''), ok, ms,
               plain_ms, bwd_flops)
        if case == 'grounded key mask':
            _bwd_rate('flash_bwd bidirectional (#6)', bwd_flops, ms,
                      results['bidirectional backward'][3], lib, card)
        del got, want

    # #6 at Sq != Skv (the cross-attention shape its TPU kernels allow):
    # the ViT's 1025 queries over 1100 keys, then the JAX test's 100 x 130;
    # a grounded key mask with row 1 fully masked, held as above
    for sq, skv in ((s, 1100), (100, 130)):
        q2, k2, v2, do2 = q[:, :, :sq], rand(b, h, skv, d), \
            rand(b, h, skv, d), do[:, :, :sq]
        mask = torch.from_numpy(_grounded_key_mask(b, skv)).to(dev)
        mask[1] = False
        want_out, lse = mha_reference(q2.float(), k2.float(), v2.float(),
                                      mask, False, d ** -0.5)
        out = want_out.to(torch.bfloat16)
        got = flash_bwd(q2, k2, v2, mask, out, lse, do2, False, d ** -0.5)
        want = flash_attention_bwd_reference(
            q2.float(), k2.float(), v2.float(), mask, out.float(), lse,
            do2.float(), False, d ** -0.5)
        worst, ref_max, ok = _grad_errors(torch, got, want, card)
        ok &= all(bool((g_[1] == 0).all()) for g_ in got)
        ms = timer(lambda: flash_bwd(q2, k2, v2, mask, out, lse, do2, False,
                                     d ** -0.5))
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q2, k2, v2, mask, out, lse, do2, False, d ** -0.5))
        report('flash_bwd bidirectional (#6)', (b, h, sq, d),
               f'Sq={sq} != Skv={skv}, grounded key mask, row 1 all masked',
               worst, ref_max, '2^-6*|plain| + 2^-8*max|plain| per gradient, '
               'row 1 exactly 0', ok, ms, plain_ms,
               2.5 * 4 * b * h * sq * skv * d)
        del got, want, k2, v2

    # --- #4 and #5: the LLM's causal forward and backward, (2, 32, 2048, 128)
    cfg = GromaConfig()
    b, h, s, d = 2, 32, cfg.max_seq_len, 128
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    mask = torch.from_numpy(grounded_kv_mask(grounded_batch(cfg, b, 7),
                                             [37, 81])).to(dev)
    case = (f'causal, grounded key mask ({int(mask[0].sum())} and '
            f'{int(mask[1].sum())} of {s} valid, region-slot gaps + pad tail)')
    causal_flops = 4 * b * h * s * s * d / 2
    got, glse = flash_fwd(q, k, v, mask, True, d ** -0.5)
    want, wlse = mha_reference(q.float(), k.float(), v.float(), mask, True,
                               d ** -0.5)
    err = (got.float() - want).abs()
    ok = bool((err <= _flash_tol(want, fwd_rel)).all())
    ok &= bool((glse - wlse).abs().max() <= 1e-3)
    ms = timer(lambda: flash_fwd(q, k, v, mask, True, d ** -0.5))
    plain_ms = timer(lambda: mha_reference(q, k, v, mask, True, d ** -0.5))
    report('flash_fwd causal (#4)', (b, h, s, d), case, err.max().item(),
           want.abs().max().item(), '2^-7*|plain| + 2^-9*max|plain|, '
           'lse 1e-3', ok, ms, plain_ms, causal_flops)
    # the same function through SDPA: causal and key mask as one boolean
    # mask (SDPA takes one or the other)
    allowed = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[
        None, None] & mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=allowed, scale=d ** -0.5)
    lib = library_time(torch, timer, 'F.scaled_dot_product_attention (#4, '
                       'causal & key mask)', sdpa, want, card)
    print(f'  its kernels: {kernel_names(torch, sdpa)} [{card}]')
    results['causal'] = (err.max().item(), ms, plain_ms,
                         bound(4 * b * h * s * d * 2 + b * s + b * h * s * 4,
                               causal_flops), lib)

    # the backward on one set of inputs: the plain forward's out and lse
    out = want.to(torch.bfloat16)
    lse = wlse
    do = rand(b, h, s, d)
    del got, want, glse
    dq, dk, dv = flash_bwd(q, k, v, mask, out, lse, do, True, d ** -0.5)
    wq, wk, wv = flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), mask, out.float(), lse, do.float(),
        True, d ** -0.5)
    worst, ref_max, ok = _grad_errors(torch, (dq, dk, dv), (wq, wk, wv), card)
    _bwd_repeat(torch, 'flash_bwd causal (#5)',
                lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                  d ** -0.5), (dq, dk, dv), (wq, wk, wv),
                card)
    # SDPA's autograd backward, from its own forward
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed,
                                              scale=d ** -0.5)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, leaves, do, retain_graph=True)
    lib = library_time(torch, timer, 'F.scaled_dot_product_attention '
                       'backward (#5)', sdpa_bwd, (wq, wk, wv), card,
                       rel_tol=3e-2)
    print(f'  its kernels: {kernel_names(torch, sdpa_bwd)} [{card}]')
    del dq, dk, dv, wq, wk, wv, sdpa_out, leaves
    ms = timer(lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                 d ** -0.5))
    plain_ms = timer(lambda: flash_attention_bwd_reference(
        q, k, v, mask, out, lse, do, True, d ** -0.5))
    report('flash_bwd causal (#5)', (b, h, s, d), case, worst, ref_max,
           '2^-6*|plain| + 2^-8*max|plain| per gradient', ok, ms, plain_ms,
           2.5 * causal_flops)
    results['backward'] = (
        worst, ms, plain_ms,
        bound(8 * b * h * s * d * 2 + b * h * s * 4 + b * s,
              2.5 * causal_flops), lib)
    _bwd_rate('flash_bwd causal (#5)', 2.5 * causal_flops, ms,
              results['backward'][3], lib, card)
    del q, k, v, out, lse, do

    # #5 at S = 1500, ragged against both the 64-query and 128-key tiles,
    # under a grounded key mask, from the plain forward
    s = 1500
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    mask = torch.from_numpy(_grounded_key_mask(b, s)).to(dev)
    want_out, lse = mha_reference(q.float(), k.float(), v.float(), mask,
                                  True, d ** -0.5)
    out = want_out.to(torch.bfloat16)
    got = flash_bwd(q, k, v, mask, out, lse, do, True, d ** -0.5)
    want = flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), mask, out.float(), lse, do.float(),
        True, d ** -0.5)
    worst, ref_max, ok = _grad_errors(torch, got, want, card)
    _bwd_repeat(torch, 'flash_bwd causal (#5), S=1500',
                lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                  d ** -0.5), got, want, card)
    ms = timer(lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                 d ** -0.5))
    plain_ms = timer(lambda: flash_attention_bwd_reference(
        q, k, v, mask, out, lse, do, True, d ** -0.5))
    report('flash_bwd causal (#5)', (b, h, s, d),
           'causal, S=1500 (ragged against 64 and 128), grounded key mask',
           worst, ref_max, '2^-6*|plain| + 2^-8*max|plain| per gradient', ok,
           ms, plain_ms, 2.5 * 4 * b * h * s * s * d / 2)
    del got, want
    return results


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


def check_int4_matmul(torch, gen, timer, card):
    """#7 against its plain version at every shape of the int4 tree: M=1
    and M=8 (the engine's 8 slots) through the decode tile, M=2048 through
    the prefill tile.  Returns (max_abs_err, (kernel ms, plain ms), (bound
    ms, bound by), library ms), the sums over the four layer matmuls at
    M=8."""
    from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, int4_matmul,
                                            int4_matmul_reference)
    dev = 'cuda'
    worst = 0.0
    layer_ms = [0.0, 0.0]
    layer_bound, bound_by, library = 0.0, '', 0.0
    cases = [(m, name, k, n) for m in (1, 8, INT4_PREFILL_ROWS)
             for name, (k, n) in INT4_MATMUL_SHAPES.items()]
    for m, name, k, n in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                               dtype=torch.uint8)
        scale = torch.rand((k // 256, n), generator=gen, device=dev) \
            * 1e-3 + 1e-4
        got = int4_matmul(x, packed, scale).float()
        want = int4_matmul_reference(x, packed, scale).float()
        err = (got - want).abs()
        # f32 sums in another order, then one bf16 rounding each: at most
        # one bf16 step (2^-7 relative) apart, plus f32 noise
        tol = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
        max_err = err.max().item()
        worst = max(worst, max_err)
        ms = timer(lambda: int4_matmul(x, packed, scale))
        plain_ms = timer(lambda: int4_matmul_reference(x, packed, scale))
        if m == 8 and name in LAYER_MATMULS:
            layer_ms[0] += ms
            layer_ms[1] += plain_ms
            b_ms, bound_by = bound(k * n // 2 + (k // 256) * n * 4
                                   + 2 * m * (k + n), 2 * m * k * n)
            layer_bound += b_ms
            if library is not None:
                try:
                    fn = _tinygemm(torch, x, packed, scale)
                except (RuntimeError, TypeError, AttributeError) as e:
                    print(f'  library torch._weight_int4pack_mm: none '
                          f'(the repacking failed: {type(e).__name__}: '
                          f'{(str(e).splitlines() or [""])[0][:140]}) '
                          f'[{card}]')
                    fn = None
                t = fn and library_time(
                    torch, timer, f'torch._weight_int4pack_mm {name}', fn,
                    want, card)
                library = None if t is None else library + t
        ref_max = want.abs().max().item()
        rate = (f'{2 * m * k * n / ms / 1e9:.1f} TFLOP/s' if m > 8 else
                f'{(k * n / 2 + k * n // 64) / ms / 1e6:.1f} GB/s weights')
        print(f'int4_matmul M={m} {name} K={k} N={n}: max_abs_err '
              f'{max_err:.3e}, rel {max_err / ref_max:.3e} of max|plain| '
              f'{ref_max:.3e} (tol 2^-7*|plain| + 1e-4*max|plain|) '
              f'{"ok" if ok else "FAIL"}; kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, {rate} [{card}]')
        if not ok:
            fail(f'int4_matmul disagrees with its plain version at M={m} '
                 f'{name}')
        if (k // 2) % INT4_BLOCK:
            # the bound must see a wrong scale on the straddling block's
            # high-nibble rows (K/2 up to its end): give them the next
            # block's scale in the plain result and count what it flags
            lo, hi = k // 2, (k // 2 // INT4_BLOCK + 1) * INT4_BLOCK
            b = lo // INT4_BLOCK
            q = (packed[:hi - lo] >> 4).float() - 8
            wrong = want + x[:, lo:hi].float() @ (q * (scale[b + 1]
                                                       - scale[b]))
            flagged = ((wrong.to(torch.bfloat16).float() - want).abs()
                       > tol).float().mean().item()
            print(f'  the same bound flags {100 * flagged:.1f} % of the '
                  f'outputs when rows {lo}..{hi - 1} (scale block {b}, high '
                  f'nibbles) take block {b + 1}\'s scale [{card}]')
            if flagged < 0.5:
                fail(f'int4_matmul M={m} {name}: the bound misses a wrong '
                     f'scale on the straddling block')
        del x, packed, scale, got, want, err
    return worst, layer_ms, (layer_bound, bound_by), library


def _tinygemm(torch, x, packed, scale, zero: float = 0.0):
    """The same product through PyTorch's tinygemm int4 call, which takes
    (q - 8) * scale + zero: our nibbles (row k and k + K/2 in one byte)
    repacked into its layout (pairs of adjacent k, then its own tiling),
    scales rounded to bf16 beside zero points of ``zero`` (0 for #7's
    biased nibbles, 8 with a scale of 1 for #10's unsigned ones), groups of
    256 rows."""
    p = packed.to(torch.int32)
    q = torch.cat([p & 0xF, p >> 4], 0).T.contiguous()        # (N, K)
    pairs = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(pairs, 8)
    sz = torch.stack([scale.to(torch.bfloat16),
                      torch.full_like(scale, zero, dtype=torch.bfloat16)], -1)
    sz = sz.contiguous()
    return lambda: torch._weight_int4pack_mm(x, w, 256, sz)


def _paged_case(torch, gen, dev):
    """The engine's paged shapes: shuffled pages, repeat-last table tails,
    a frozen row (length 0) on the trash page."""
    from groma_tpu_torch.models.llama_quant import _quantize_tokens
    from groma_tpu_torch.ops.paged_attention import PAGE
    h, d = 32, 128
    b = len(PAGED_LENGTHS)
    np_ = -(-max(PAGED_LENGTHS) // PAGE)
    k8, ks = _quantize_tokens(torch.randn(
        (PAGED_POOL_PAGES, h, PAGE, d), generator=gen, device=dev))
    v8, vs = _quantize_tokens(torch.randn(
        (PAGED_POOL_PAGES, h, PAGE, d), generator=gen, device=dev))
    ids = (torch.randperm(PAGED_POOL_PAGES - 1, generator=gen, device=dev)
           + 1).tolist()
    table = torch.zeros((b, np_), dtype=torch.int32)
    for row, n in enumerate(PAGED_LENGTHS):
        used = -(-n // PAGE)
        if used:
            table[row, :used] = torch.tensor(ids[:used])
            table[row, used:] = ids[used - 1]
            ids = ids[used:]
    q = torch.randn((b, h, 1, d), generator=gen, device=dev)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    return (q, k8, ks, v8, vs, table.to(dev), lengths)


def check_paged_attention(torch, gen, timer, card):
    """#8 against its plain version at the engine's shapes.  Returns
    (max_abs_err, kernel ms, plain ms, (bound ms, bound by)); no PyTorch
    call computes it."""
    from groma_tpu_torch.ops.paged_attention import (
        PAGE, paged_int8_decode_attention, paged_int8_decode_attention_plain)
    args = _paged_case(torch, gen, 'cuda')
    got = paged_int8_decode_attention(*args)
    want, step = paged_int8_decode_attention_plain(*args, with_step=True)
    err = (got - want).abs()
    # the kernel's f32 exp and sums may differ from torch's in the last
    # bit, so a requantized p on a .5 tie may round the other way: allow
    # two such units of any page, plus f32 noise
    tol = 2 * step + 1e-5 * want.abs().max()
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    frozen = len(PAGED_LENGTHS) - 1
    ok &= bool(got[frozen].abs().max() > 0)    # uniform p, not 0
    max_err = err.max().item()
    units = (err / step).max().item()
    ms = timer(lambda: paged_int8_decode_attention(*args))
    plain_ms = timer(lambda: paged_int8_decode_attention_plain(*args))
    h, d = args[0].shape[1], args[0].shape[3]
    pages = sum(-(-n // PAGE) if n else args[5].shape[1]
                for n in PAGED_LENGTHS)
    kv_bytes = pages * h * 2 * PAGE * (d + 4)
    ref_max = want.abs().max().item()
    print(f'paged_int8_decode_attention B={len(PAGED_LENGTHS)} H={h} D={d} '
          f'lengths {PAGED_LENGTHS} over a {PAGED_POOL_PAGES}-page pool: '
          f'max_abs_err {max_err:.3e}, rel {max_err / ref_max:.3e} of '
          f'max|plain| {ref_max:.3e}, {units:.3f} p8 units (tol 2 units + '
          f'1e-5*max|plain|), frozen row finite and uniform '
          f'{"ok" if ok else "FAIL"}; kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, {kv_bytes / ms / 1e6:.1f} GB/s KV [{card}]')
    if not ok:
        fail('paged_int8_decode_attention disagrees with its plain version')
    b = len(PAGED_LENGTHS)
    return max_err, ms, plain_ms, bound(
        kv_bytes + 2 * b * h * d * 4 + args[5].numel() * 4 + b * 4,
        4 * sum(PAGED_LENGTHS) * h * d, H100_INT8_OPS)


def check_int4_paged_path(torch, seed: int, card: str):
    """The engine's LLaMA path at full width and two layers, int4 weights:
    prefill into an int8 cache, its pages compacted into a page pool, then
    paged decode steps; on the card (the kernels) against the same weights
    and inputs on the CPU (the plain versions)."""
    from groma_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_decode_paged,
                                                    quant_llama_forward,
                                                    quantize_llama_params)
    from groma_tpu_torch.ops.paged_attention import (PAGE,
                                                     insert_prefill_pages,
                                                     make_kv_page_pool)
    cfg = LlamaConfig(num_layers=2)           # Vicuna-7B width, bf16
    torch.manual_seed(seed)
    with torch.no_grad():
        llm = LlamaForCausalLM(cfg, device='cuda')
        qp = quantize_llama_params(llm.state_dict(), cfg, bits=4)
        del llm
    b, s, steps = 2, 2 * PAGE, 4          # prefill M = 512: the mma tile
    gen = torch.Generator().manual_seed(seed)
    emb = torch.randn((b, s, cfg.hidden_size), generator=gen)
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[1, 100:140] = False             # a gap, compacted away
    valid[1, 220:] = False
    pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
    steps_in = [torch.randn((b, 1, cfg.hidden_size), generator=gen)
                for _ in range(steps)]
    # slot 0 on pages (3, 5, 2), slot 1 on (7, 1, 1); page 0 is trash
    pages = [[3, 5, 2], [7, 1, 1]]

    def run(device):
        tree = {'norm': qp['norm'].to(device), 'layers': [
            {k: ({kk: vv.to(device) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in lp.items()} for lp in qp['layers']]}
        move = lambda t: t.to(device)          # noqa: E731
        cache = make_quant_kv_cache(cfg, b, s, device=device)
        h, cache = quant_llama_forward(tree, cfg, move(emb), move(valid),
                                       move(pos), cache)
        outs = [h.float().cpu()]
        pools = make_kv_page_pool(cfg, 8, device=device)
        for row in range(b):
            insert_prefill_pages(pools, cache, row,
                                 torch.tensor(pages[row][:2], device=device),
                                 valid=cache['mask'][row])
        table = torch.tensor(pages, dtype=torch.int32, device=device)
        nxt = valid.sum(-1).long()[:, None]       # compacted write positions
        for i, x in enumerate(steps_in):
            p_ = move(nxt + i)
            h, pools = quant_llama_decode_paged(
                tree, cfg, move(x), p_, pools, table,
                (p_[:, 0] + 1).to(torch.int32))
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
            fail(f'int4 + paged LLaMA path: '
                 f'{"prefill" if i == 0 else "paged decode"} step {i} '
                 f'differs from the CPU plain path by {err:.3e}')
    print(f'int4 + paged LLaMA path, full width, 2 layers, B={b}: prefill '
          f'{s} tokens (int4 mma tile), compacted into pages, + {steps} paged '
          f'decode steps on the card match the CPU plain path within '
          f'{worst:.3e} x max|hidden| (tol 3e-2) [{card}]')


def _megakernel_traffic(cfg, n_layers: int, b: int, s: int, reads):
    """(bytes, operations) one decode step of #9 needs: every layer's int4
    weights and scales and norm scales read once; per layer and (b, head),
    the cache rows the kernel must read (``reads[b]`` positions, k and v
    with their scales) and the written column; x in and out, the RoPE rows
    and the mask entries read."""
    d, f, h = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads
    shapes = ((d, 3 * d), (d, d), (d, 2 * f), (f, d))
    weights = sum(k * n // 2 + (k // 256) * n * 4 for k, n in shapes)
    params = sum(k * n for k, n in shapes)
    kv = sum(reads) * h * 2 * (128 + 4)
    per_layer = weights + 2 * d * 4 + kv + b * h * 2 * (128 + 4)
    nbytes = n_layers * per_layer + 2 * b * d * 4 + 2 * b * 128 * 4 \
        + sum(reads) * 4 + b * 4
    ops = n_layers * (2 * b * params + 4 * sum(reads) * h * 128)
    return nbytes, ops


def _stacked_clone(torch, mk, st):
    """A copy of a (stacked) cache on buffers of its own, stacked."""
    return mk.stack_kv_cache({k: ([t.clone() for t in v] if isinstance(v, list)
                                  else v) for k, v in st.items()})


def _compare_step(torch, got, want, before, mine, theirs, pos: int) -> dict:
    """#9's step (``got``, cache ``mine``) against its plain version
    (``want``, cache ``theirs``), both run from the cache ``before``: the
    hidden state relative to max|plain|, every layer's written column (int8
    bytes that differ, the largest difference, scales relative) and whether
    every other cache byte and scale is bitwise unchanged."""
    err = (got - want).abs().max().item()
    c = {'err': err, 'rel': err / want.abs().max().item(),
         'finite': bool(torch.isfinite(got).all()), 'off': 0, 'bytes': 0,
         'byte_diff': 0, 'scale_rel': 0.0, 'rest_equal': True}
    for key in ('k', 'v'):
        for li in range(len(before[key])):
            kq, pq = mine[key][li], theirs[key][li]
            diff = (kq[:, :, pos].int() - pq[:, :, pos].int()).abs()
            c['byte_diff'] = max(c['byte_diff'], int(diff.max()))
            c['off'] += int((diff > 0).sum())
            c['bytes'] += diff.numel()
            ks_ = mine[key + '_scale'][li][:, :, pos]
            ps_ = theirs[key + '_scale'][li][:, :, pos]
            c['scale_rel'] = max(c['scale_rel'],
                                 ((ks_ - ps_).abs() / ps_).max().item())
            for t, orig in ((kq, before[key][li]),
                            (mine[key + '_scale'][li],
                             before[key + '_scale'][li])):
                rest = t.clone()
                rest[:, :, pos] = orig[:, :, pos]
                c['rest_equal'] &= torch.equal(rest, orig)
    return c


def _step_ok(c: dict, hidden_tol: float, column: bool = True) -> bool:
    ok = c['finite'] and c['rel'] <= hidden_tol and c['rest_equal']
    if column:
        ok &= c['byte_diff'] <= 1 and c['scale_rel'] <= MEGAKERNEL_SCALE_TOL
    return ok


def _step_line(c: dict, hidden_tol: float, column: bool = True) -> str:
    held = ((' (tol 1 unit)', f' (tol {MEGAKERNEL_SCALE_TOL})') if column
            else (' (not held)', ' (not held)'))
    return (f'hidden max_abs_err {c["err"]:.3e}, rel {c["rel"]:.3e} of '
            f'max|plain| (tol {hidden_tol}); written column {c["off"]} of '
            f'{c["bytes"]} int8 bytes off, by at most {c["byte_diff"]}'
            f'{held[0]}, scales rel {c["scale_rel"]:.2e}{held[1]}; every '
            f'other cache byte and scale unchanged: {c["rest_equal"]} '
            f'{"ok" if _step_ok(c, hidden_tol, column) else "FAIL"}')


def check_decode_megakernel(torch, gen, timer, seed: int, card: str):
    """(a) #9 against its plain version at full width (D 4096, 32 heads of
    128, F 11008) and 2 stacked layers: B=8, a 1024-slot cache written up
    to MEGAKERNEL_POS, a ragged mask (rows valid to different lengths, a
    hole in row 1) and row 7 fully masked (its token too)."""
    from groma_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from groma_tpu_torch.models.llama_quant import (megakernel_step_inputs,
                                                    quantize_llama_params)
    from groma_tpu_torch.ops import decode_megakernel as mk
    cfg = LlamaConfig(num_layers=2)
    torch.manual_seed(seed)
    with torch.no_grad():
        llm = LlamaForCausalLM(cfg, device='cuda')
        qp = quantize_llama_params(llm.state_dict(), cfg, bits=4)
        del llm
    sp = mk.stack_decode_params(qp)
    b, s, pos = DECODE_BATCH, DECODE_SLOTS, MEGAKERNEL_POS
    h, d, dev = cfg.num_heads, cfg.hidden_size, 'cuda'
    cache = {'k': [], 'v': [], 'k_scale': [], 'v_scale': []}
    for _ in range(cfg.num_layers):
        for key in ('k', 'v'):
            t = torch.randint(-127, 128, (b, h, s, 128), generator=gen,
                              device=dev, dtype=torch.int8)
            t[:, :, pos:] = 0
            cache[key].append(t)
            sc = torch.rand((b, h, s), generator=gen, device=dev) * 0.02 \
                + 0.005
            sc[:, :, pos:] = 0
            cache[key + '_scale'].append(sc)
    lengths = torch.tensor([pos - 37 * r for r in range(b)], device=dev)
    valid = torch.arange(s, device=dev)[None] < lengths[:, None]
    valid[1, 100:160] = False
    valid[b - 1] = False
    cache['mask'], cache['index'] = valid, pos
    cur_valid = torch.ones((b, 1), dtype=torch.bool, device=dev)
    cur_valid[b - 1] = False
    mine, theirs = (_stacked_clone(torch, mk, cache) for _ in range(2))
    x = torch.randn((b, d), generator=gen, device=dev)
    inputs = megakernel_step_inputs(cfg, cache, cur_valid)
    eps = cfg.rms_norm_eps
    with torch.no_grad():
        got = mk.fused_decode_step(sp, x, mine, *inputs, pos, eps=eps)
        want = mk.fused_decode_step_plain(sp, x, theirs, *inputs, pos,
                                          eps=eps)
        torch.cuda.synchronize()
        cmp = _compare_step(torch, got, want, cache, mine, theirs, pos)
        ok = _step_ok(cmp, MEGAKERNEL_HIDDEN_TOL)
        reads = [s if not bool(cur_valid[r]) else pos for r in range(b)]
        bound_ms, bound_by = bound(*_megakernel_traffic(
            cfg, cfg.num_layers, b, s, reads))
        ms = timer(lambda: mk.fused_decode_step(sp, x, mine, *inputs, pos,
                                                eps=eps))
        plain_ms = timer(lambda: mk.fused_decode_step_plain(
            sp, x, theirs, *inputs, pos, eps=eps), iters=3)
    print(f'decode_megakernel (#9) full width, {cfg.num_layers} layers, '
          f'B={b} S={s} pos={pos}, ragged mask, row {b - 1} fully masked: '
          f'{_step_line(cmp, MEGAKERNEL_HIDDEN_TOL)}; kernel {ms:.4f} ms '
          f'({mk.fused_decode_step.blocks} blocks), plain {plain_ms:.4f} ms, '
          f'bound {bound_ms:.4f} ms ({bound_by}) [{card}]')
    if not ok:
        fail('decode_megakernel disagrees with its plain version')
    del qp, sp, cache, mine, theirs


def device_per_step(torch, step, n: int = PROFILED_STEPS):
    """``n`` calls of ``step`` under torch.profiler -> (device ms, device
    operations, wall ms) a call."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type.name == 'CUDA' and e.device_time > 0]
    return (sum(e.device_time for e in events) / 1e3 / n, len(events) / n,
            wall * 1e3 / n)


def decode_megakernel_path(torch, timer, seed: int, card: str):
    """(b) the decode benchmark's path through the port at full depth: the
    random full-width Vicuna-7B int4 tree from ``seed``, B=8, a 512-token
    random prompt prefilled per layer into a 1024-slot int8 cache, then
    MEGAKERNEL_STEPS greedy steps through quant_llama_decode_megakernel
    (one launch each), then the same tokens teacher-forced through the
    per-layer quant_llama_forward on a copy of the prefilled cache.
    Then the kernel alone at the last slot against its plain version.
    Returns the megakernel's launches and (max_abs_err, kernel ms, plain ms,
    bound ms, bound by) at the last slot."""
    from groma_tpu_torch.checkpoint.loader import random_groma
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.models.llama_quant import (
        make_quant_kv_cache, megakernel_step_inputs,
        quant_llama_decode_megakernel, quant_llama_forward,
        quant_llama_logits)
    from groma_tpu_torch.ops import decode_megakernel as mk
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.quant4 import int4_matmul
    gcfg = GromaConfig()
    cfg = gcfg.llm
    b, pre, slots, steps = (DECODE_BATCH, DECODE_PROMPT, DECODE_SLOTS,
                            MEGAKERNEL_STEPS)
    n_layers, dev = cfg.num_layers, 'cuda'
    t0 = time.perf_counter()
    model, qp = random_groma(gcfg, seed=seed, device=dev, bits=4)
    del model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    ids = torch.randint(0, cfg.vocab_size, (b, pre), generator=gen,
                        device=dev)
    one = torch.ones((b, 1), dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache = make_quant_kv_cache(cfg, b, slots, device=dev)
        h, cache = quant_llama_forward(
            qp, cfg, qp['embed_tokens'][ids],
            torch.ones((b, pre), dtype=torch.bool, device=dev),
            torch.arange(pre, device=dev)[None].expand(b, pre), cache)
        tok = quant_llama_logits(qp, h[:, -1:])[:, 0].argmax(-1)
        per_layer = {k: ([t.clone() for t in v] if isinstance(v, list)
                         else v.clone() if torch.is_tensor(v) else v)
                     for k, v in cache.items()}
        sp = mk.stack_decode_params(qp)
        st = mk.stack_kv_cache(cache)
        torch.cuda.synchronize()
        print(f'decode path: random full-width Vicuna-7B int4 tree '
              f'({n_layers} layers) and a {b} x {pre}-token per-layer '
              f'prefill into a {slots}-slot int8 cache in '
              f'{time.perf_counter() - t0:.1f} s; device memory '
              f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]')

        def counts():
            return (mk.fused_decode_step.launches, int4_matmul.launches,
                    int8_decode_attention.launches)

        def zero():
            mk.fused_decode_step.launches = 0
            int4_matmul.launches = 0
            int8_decode_attention.launches = 0

        # the megakernel path, greedy; the main path's counts
        toks, hidden, wall, device_ms, per_step = [], [], [], [], set()
        zero()
        for _ in range(steps):
            toks.append(tok)
            before = mk.fused_decode_step.launches
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            hm, st = quant_llama_decode_megakernel(
                qp, sp, cfg, qp['embed_tokens'][tok][:, None], one, st)
            e1.record()
            per_step.add(mk.fused_decode_step.launches - before)
            tok = quant_llama_logits(qp, hm)[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            device_ms.append(e0.elapsed_time(e1))
            hidden.append(hm[:, 0])
        mk_counts = counts()
        # the per-layer path on the same tokens
        zero()
        worst, worst_mean, pl_wall = 0.0, 0.0, []
        for i in range(steps):
            t0 = time.perf_counter()
            hp, per_layer = quant_llama_forward(
                qp, cfg, qp['embed_tokens'][toks[i]][:, None], one,
                torch.full((b, 1), pre + i, device=dev), per_layer)
            torch.cuda.synchronize()
            pl_wall.append(time.perf_counter() - t0)
            diff = (hidden[i].float() - hp[:, 0].float()).abs()
            worst = max(worst, diff.max().item()
                        / hp.float().abs().max().item())
            worst_mean = max(worst_mean, diff.mean().item()
                             / hp.float().abs().mean().item())
        pl_counts = counts()

        want_mk = (steps, steps, 0)                 # + the lm head a step
        want_pl = (0, 4 * n_layers * steps, n_layers * steps)
        finite = all(bool(torch.isfinite(x).all()) for x in hidden)
        in_vocab = all(bool(((t >= 0) & (t < cfg.vocab_size)).all())
                       for t in toks)
        ok = (mk_counts == want_mk and per_step == {1}
              and pl_counts == want_pl and finite
              and in_vocab and worst <= MEGAKERNEL_PATH_TOL
              and st['index'] == per_layer['index'] == pre + steps)
        warm = sorted(wall[1:])
        pl_warm = sorted(pl_wall[1:])
        mk_ms = warm[len(warm) // 2] * 1e3
        pl_ms = pl_warm[len(pl_warm) // 2] * 1e3
        dev_ms = sorted(device_ms[1:])[len(device_ms) // 2]
        avg_reads = pre + (steps - 1) / 2
        avg_bound = bound(*_megakernel_traffic(cfg, n_layers, b, slots,
                                               [avg_reads] * b))
        print(f'decode path, megakernel: {steps} greedy steps at B={b}, '
              f'{mk_ms:.2f} ms/step median ({b / mk_ms * 1e3:.1f} tok/s), '
              f'device time of the decode call {dev_ms:.3f} ms/step median '
              f'(CUDA events), bound {avg_bound[0]:.3f} ms/step at the mean '
              f'slot ({avg_bound[1]}); launches megakernel {mk_counts[0]}, '
              f'int4_matmul {mk_counts[1]} (the lm head), decode attention '
              f'{mk_counts[2]} (want {want_mk}), megakernel launches in a '
              f'step {sorted(per_step)} (want [1]) [{card}]')
        print(f'decode path, per-layer (teacher-forced on the same tokens): '
              f'{pl_ms:.2f} ms/step median ({b / pl_ms * 1e3:.1f} tok/s); '
              f'launches megakernel {pl_counts[0]}, int4_matmul (#7) '
              f'{pl_counts[1]}, decode attention (#2) {pl_counts[2]} (want '
              f'{want_pl}); hidden states against the megakernel path: '
              f'worst step max|diff| {worst:.3e} x max|hidden| (tol '
              f'{MEGAKERNEL_PATH_TOL}), mean|diff| {worst_mean:.3e} x '
              f'mean|hidden| {"ok" if ok else "FAIL"} [{card}]')
        if not ok:
            fail('the megakernel decode path failed its checks')

        # device time and operations a step of each path, after the counts
        def mk_step():
            nonlocal tok, st
            hm, st = quant_llama_decode_megakernel(
                qp, sp, cfg, qp['embed_tokens'][tok][:, None], one, st)
            tok = quant_llama_logits(qp, hm)[:, -1].argmax(-1)

        def pl_step():
            nonlocal per_layer
            _, per_layer = quant_llama_forward(
                qp, cfg, qp['embed_tokens'][tok][:, None], one,
                torch.full((b, 1), per_layer['index'], device=dev),
                per_layer)
        for name, step in (('megakernel', mk_step), ('per-layer', pl_step)):
            ms_dev, ops, wall_ms = device_per_step(torch, step)
            print(f'decode path, {name}, {PROFILED_STEPS} steps under '
                  f'torch.profiler: {ms_dev:.3f} ms of device time and '
                  f'{ops:.0f} device operations a step, {wall_ms:.2f} ms '
                  f'wall a step (profiler cost included): device busy '
                  f'{100 * ms_dev / wall_ms:.1f} % [{card}]')

        # the kernel alone at the path's last slot against its plain
        # version, on copies of the path's cache: the path's 32-layer
        # launch, then each layer alone on the plain version's input to it
        index = st['index']
        x = qp['embed_tokens'][tok].float()
        inputs = megakernel_step_inputs(cfg, st, one)
        eps = cfg.rms_norm_eps
        mine, theirs = (_stacked_clone(torch, mk, st) for _ in range(2))
        got = mk.fused_decode_step(sp, x, mine, *inputs, index, eps=eps)
        want = mk.fused_decode_step_plain(sp, x, theirs, *inputs, index,
                                          eps=eps)
        cmp = _compare_step(torch, got, want, st, mine, theirs, index)
        ok = _step_ok(cmp, MEGAKERNEL_DEPTH_TOL, column=False)
        # the plain step against itself with its input moved by 1e-6
        # relative: the drift that rounding alone causes over 32 layers
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 23)
        moved = _stacked_clone(torch, mk, st)
        drift = _compare_step(torch, mk.fused_decode_step_plain(
            sp, x * (1 + 1e-6 * torch.randn(x.shape, generator=gen,
                                             device=dev)),
            moved, *inputs, index, eps=eps), want, st, moved, theirs, index)
        del moved
        layers, xi = [], x
        for i in range(n_layers):
            kv = {k: [st[k][i]] for k in ('k', 'v', 'k_scale', 'v_scale')}
            kv.update(mask=st['mask'], index=index)
            spi = mk.stack_decode_params({'layers': [qp['layers'][i]]})
            mi, ti = (_stacked_clone(torch, mk, kv) for _ in range(2))
            gi = mk.fused_decode_step(spi, xi, mi, *inputs, index, eps=eps)
            xi = mk.fused_decode_step_plain(spi, xi, ti, *inputs, index,
                                            eps=eps)
            layers.append(_compare_step(torch, gi, xi, kv, mi, ti, index))
            ok &= _step_ok(layers[-1], MEGAKERNEL_HIDDEN_TOL)
        worst = max(range(n_layers), key=lambda i: layers[i]['rel'])
        each = {'err': max(c['err'] for c in layers),
                'rel': layers[worst]['rel'],
                'finite': all(c['finite'] for c in layers),
                'off': sum(c['off'] for c in layers),
                'bytes': sum(c['bytes'] for c in layers),
                'byte_diff': max(c['byte_diff'] for c in layers),
                'scale_rel': max(c['scale_rel'] for c in layers),
                'rest_equal': all(c['rest_equal'] for c in layers)}
        ms = timer(lambda: mk.fused_decode_step(sp, x, mine, *inputs, index,
                                                eps=eps))
        plain_ms = timer(lambda: mk.fused_decode_step_plain(
            sp, x, theirs, *inputs, index, eps=eps), iters=2)
        bound_ms, bound_by = bound(*_megakernel_traffic(
            cfg, n_layers, b, slots, [index] * b))
        print(f'decode_megakernel (#9) alone, {n_layers} layers, B={b}, slot '
              f'{index} of {slots}: '
              f'{_step_line(cmp, MEGAKERNEL_DEPTH_TOL, column=False)}; '
              f'kernel {ms:.3f} ms ({mk.fused_decode_step.blocks} blocks), '
              f'plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms '
              f'({bound_by}), {100 * bound_ms / ms:.1f} % of the bound '
              f'[{card}]')
        print(f'  the plain step against itself with its input moved by 1e-6 '
              f'relative: hidden rel {drift["rel"]:.3e} of max|plain|, '
              f'{drift["off"]} of {drift["bytes"]} written int8 bytes '
              f'changed [{card}]')
        print(f'  each of the {n_layers} layers alone (one launch, one '
              f'layer\'s weights and cache) on the plain version\'s input to '
              f'it: worst layer {worst}: '
              f'{_step_line(each, MEGAKERNEL_HIDDEN_TOL)} [{card}]')
        if not ok:
            fail(f'decode_megakernel disagrees with its plain version at '
                 f'{n_layers} layers')
    del qp, sp, st, cache, per_layer, hidden, mine, theirs
    return mk_counts[0], (cmp['err'], ms, plain_ms, bound_ms, bound_by)


def _train_args(batch):
    return dict(images=batch['images'], input_ids=batch['input_ids'],
                region_slot=batch['region_slot'], base_valid=batch['valid'],
                labels=batch['labels'], ground_boxes=batch['ground_boxes'],
                ground_valid=batch['ground_valid'],
                refer_boxes=batch['refer_boxes'],
                refer_valid=batch['refer_valid'])


def check_stage3(torch, seed: int, card: str):
    """Stage 3 (LLM trained) at full width and 2 LLM layers: one step's
    loss and trainable gradients on the card (the kernels, bf16) against
    the same weights and batch on the CPU (the plain versions, f32).

    The CPU side takes the card's ViT hidden states (the ViT runs without
    gradient; its kernel is checked in phase 2): NMS is discrete, and bf16
    against f32 features reorders near-tied proposals, which changes the
    selected regions and so the <rK> labels.  Everything after the ViT
    (DDETR, NMS, region encoder, bridge, LLM, CE) runs on both sides."""
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.models.groma import GromaConfig, GromaModel
    from groma_tpu_torch.models.llama import LlamaConfig
    from groma_tpu_torch.train.optimizer import freeze_predicate, make_adamw
    from groma_tpu_torch.train.steps import batch_to
    from groma_tpu_torch.train.synthetic import grounded_batch
    cfg = GromaConfig(llm=LlamaConfig(num_layers=2))
    batch = grounded_batch(cfg, 1, seed + 3)
    f32 = cfg.replace(llm=cfg.llm.replace(dtype='float32'),
                      perceiver=cfg.perceiver.replace(
                          vit=cfg.perceiver.vit.replace(dtype='float32')))
    card_model = random_groma_full(cfg, seed=seed, device='cuda')
    cpu_model = GromaModel(f32, device='meta', full_precision=True)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()}, assign=True)
    vit_states = []
    encode = card_model.perceiver.encode_image

    def recording(images, use_flash=False):
        vit_states.append(encode(images, use_flash))
        return vit_states[-1]
    card_model.perceiver.encode_image = recording
    # as they are (bf16): the DDETR features average them in that dtype
    cpu_model.perceiver.encode_image = lambda images, use_flash=False: tuple(
        h.cpu() for h in vit_states[0])
    frozen = freeze_predicate(freeze_perceiver=True, freeze_llm=False)
    results = {}
    for name, model, dev in (('card', card_model, 'cuda'),
                             ('cpu', cpu_model, 'cpu')):
        opt = make_adamw(model, 1e-5, frozen_pred=frozen)
        t0 = time.perf_counter()
        out = model(**_train_args(batch_to(batch, dev)), use_flash=True)
        out['loss'].backward()
        grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        opt.step()
        if dev == 'cuda':
            torch.cuda.synchronize()
        results[name] = (out['loss'].item(), grads,
                         time.perf_counter() - t0,
                         out['vis']['selected_mask'].cpu(),
                         out['final_input_ids'].cpu())
        bad = [k for k, p in model.named_parameters()
               if not torch.isfinite(p).all()]
        if bad:
            fail(f'stage 3 step on the {name}: non-finite params {bad[:3]}')
    (g_loss, g_grads, g_s, g_sel, g_ids), (c_loss, c_grads, c_s, c_sel,
                                           c_ids) = results['card'], \
        results['cpu']
    if not (torch.equal(g_sel, c_sel) and torch.equal(g_ids, c_ids)):
        fail(f'stage 3: the card and the CPU selected different regions '
             f'({int(g_sel.sum())} vs {int(c_sel.sum())} kept, '
             f'{int((g_ids != c_ids).sum())} stream ids differ)')
    if g_grads.keys() != c_grads.keys() or not any(
            k.startswith('llm.') for k in g_grads):
        fail('stage 3: the card and the CPU trained different parameters')
    loss_rel = abs(g_loss - c_loss) / abs(c_loss)
    # bf16 activations through the region encoder and 2 LLaMA layers
    # against f32: per gradient tensor, the relative Frobenius error, and
    # the error of the whole trainable gradient
    rel = {k: ((g_grads[k] - c_grads[k]).norm()
               / c_grads[k].norm().clamp(min=1e-30)).item()
           for k in c_grads}
    total = (sum(((g_grads[k] - c_grads[k]) ** 2).sum() for k in c_grads)
             / sum((c_grads[k] ** 2).sum() for k in c_grads)).sqrt().item()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    ok = loss_rel <= STAGE3_LOSS_TOL and total <= STAGE3_GRAD_TOL and all(
        v <= STAGE3_TENSOR_TOL for v in rel.values()) and all(
        torch.isfinite(g).all() for g in g_grads.values())
    print(f'stage 3 (LLM trained), full width, 2 LLM layers, B=1 S='
          f'{cfg.max_seq_len}: same {int(g_sel.sum())} regions selected; '
          f'loss card {g_loss:.6f} vs CPU {c_loss:.6f} '
          f'(rel {loss_rel:.2e}, tol {STAGE3_LOSS_TOL}); {len(rel)} trainable '
          f'gradients, whole-gradient rel err {total:.2e} (tol '
          f'{STAGE3_GRAD_TOL}), worst tensors '
          + ', '.join(f'{k} {v:.2e}' for k, v in worst)
          + f' (tol {STAGE3_TENSOR_TOL}) {"ok" if ok else "FAIL"}; card step '
          f'{g_s * 1e3:.1f} ms (cold), CPU {c_s:.1f} s [{card}]')
    if not ok:
        fail('stage 3: the card step disagrees with the CPU plain path')
    del card_model, cpu_model, results, g_grads, c_grads, vit_states


def train_full_width(torch, np, seed: int, card: str):
    """Stage 2 (vl_pretrain.sh: perceiver and LLM frozen) at full Groma-7B
    through the port's train_vl functions.  Returns the flash kernels'
    launches over the checked steps."""
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from groma_tpu_torch.train.optimizer import (cosine_schedule,
                                                 freeze_predicate, make_adamw)
    from groma_tpu_torch.train.steps import batch_to, make_vl_train_step
    from groma_tpu_torch.train.synthetic import grounded_batch
    cfg = GromaConfig()
    b, steps = TRAIN_BATCH, TRAIN_STEPS
    t0 = time.perf_counter()
    model = random_groma_full(cfg, seed=seed, device='cuda')
    opt = make_adamw(model, cosine_schedule(1e-4, steps, warmup_ratio=0.03),
                     frozen_pred=freeze_predicate(freeze_perceiver=True,
                                                  freeze_llm=True))
    step_fn = make_vl_train_step(model, opt, use_flash=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    batch = batch_to(grounded_batch(cfg, b, seed + 5), 'cuda')
    trainable = {k: p.detach().clone() for k, p in model.named_parameters()
                 if p.requires_grad}
    frozen = [(k, p) for k, p in model.named_parameters()
              if not p.requires_grad]

    def bits(p):
        return p.detach().view(torch.int32).sum(dtype=torch.int64).item()
    frozen_bits = {k: bits(p) for k, p in frozen}
    frozen_copy = {k: model.get_parameter(k).detach().cpu().clone() for k in (
        'perceiver.vis_encoder.encoder.layer.0.attention.attention.query.weight',
        'llm.model.layers.0.self_attn.q_proj.weight',
        'llm.model.embed_tokens.weight', 'llm.lm_head.weight')}
    torch.cuda.synchronize()
    n_valid = int(batch['valid'].sum())
    print(f'stage 2 training: random full-width Groma-7B (f32 master '
          f'weights) built in {time.perf_counter() - t0:.1f} s; '
          f'{sum(v.numel() for v in trainable.values())} of '
          f'{sum(p.numel() for p in model.parameters())} parameters train; '
          f'B={b} S={cfg.max_seq_len} ({n_valid} valid stream slots); '
          f'device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB '
          f'[{card}]')

    def counts():
        return (flash_fwd.launches['bidirectional'],
                flash_fwd.launches['causal'], flash_bwd.launches['causal'])
    flash_fwd.launches.update(bidirectional=0, causal=0)
    flash_bwd.launches.update(bidirectional=0, causal=0)
    per_step = (cfg.perceiver.vit.num_layers, cfg.llm.num_layers,
                cfg.llm.num_layers)
    times = []
    for i in range(steps):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step_fn(batch, gen)
        loss = metrics['loss'].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        got = tuple(c - n for c, n in zip(counts(), before))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'  step {i}: loss {loss:.5f}, {dt * 1e3:.1f} ms, '
              f'{b * cfg.max_seq_len / dt:.0f} stream slots/s, peak '
              f'{peak:.2f} GiB, lr {opt.schedule(i):.3e}; launches '
              f'bidirectional fwd {got[0]}, causal fwd {got[1]}, causal bwd '
              f'{got[2]} '
              f'[{card}]')
        if got != per_step:
            fail(f'training step {i}: flash launches {got}, want {per_step} '
                 f'(one per ViT layer, one fwd + one bwd per LLM layer)')
        if not np.isfinite(loss):
            fail(f'training step {i}: loss {loss}')
    launches = counts()

    changed_bits = [k for k, p in frozen if bits(p) != frozen_bits[k]]
    changed_copy = [k for k, v in frozen_copy.items()
                    if not torch.equal(model.get_parameter(k).cpu(), v)]
    if changed_bits or changed_copy:
        fail(f'frozen parameters changed: {(changed_bits + changed_copy)[:5]}')
    still = [k for k, v in trainable.items()
             if torch.equal(model.get_parameter(k), v)]
    if still:
        fail(f'trainable parameters unchanged after {steps} steps: '
             f'{still[:5]}')
    warm = sorted(times[1:])
    print(f'stage 2 checks passed: {len(frozen)} frozen tensors bitwise '
          f'unchanged, all {len(trainable)} trainable tensors changed; warm '
          f'steps {warm[len(warm) // 2] * 1e3:.1f} ms median of '
          f'{len(warm)} [{card}]')
    profile_steps(torch, step_fn, batch, gen, b * cfg.max_seq_len, card)
    del model, opt, step_fn, trainable, batch
    return launches


def profile_steps(torch, step_fn, batch, gen, slots: int, card: str,
                  n: int = 2):
    """``n`` steps under torch.profiler: device busy share and the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn(batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type.name == 'CUDA' and e.device_time > 0]
    device_ms = sum(e.device_time for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f'profiled {n} steps: wall {wall * 1e3 / n:.1f} ms/step, device '
          f'kernel time {device_ms / n:.1f} ms/step, busy '
          f'{100 * device_ms / (wall * 1e3):.1f} %, '
          f'{slots * n / wall:.0f} stream slots/s [{card}]')
    for name, ms in top:
        print(f'  {ms / n:9.2f} ms/step  {name[:100]} [{card}]')


def random_image(np, seed: int, size: int):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((size, size, 3)).astype(np.float32)


def _spread(seconds) -> str:
    """'median ms (min to max)' of sorted host-clock times."""
    mid = seconds[len(seconds) // 2]
    return (f'{mid * 1e3:.1f} ms ({seconds[0] * 1e3:.1f} to '
            f'{seconds[-1] * 1e3:.1f})')


def vit_backward_full_width(torch, seed: int, card: str):
    """DINOv2-L at full width (24 layers, 448², B=VIT_BATCH, f32 master
    weights computing in bf16) forward and backward through the port's
    Dinov2Model with use_flash=True, and the same weights, images and scalar
    with use_flash=False (the plain attention) on the card.  Each path runs
    VIT_RUNS times (all but the first timed on the host clock), then twice
    under torch.profiler (device kernel time); the counts are zeroed before
    each checked run and read after it: exactly one bidirectional forward
    and one bidirectional backward launch per layer with the kernels, none
    without.  Returns the bidirectional backward's launches of the last
    checked flash run."""
    from groma_tpu_torch.checkpoint.loader import _fill
    from groma_tpu_torch.models.dinov2 import Dinov2Model
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    pc = GromaConfig().perceiver
    c = pc.vit
    model = Dinov2Model(c, deploy_image_size=pc.image_size, device='meta',
                        dtype=torch.float32, compute_dtype=torch.bfloat16)
    model.to_empty(device='cuda')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    with torch.no_grad():
        _fill(model, gen)
    images = torch.randn((VIT_BATCH, pc.image_size, pc.image_size, 3),
                         generator=gen, device='cuda')
    tokens = 1 + (pc.image_size // c.patch_size) ** 2
    weight = torch.randn((VIT_BATCH, tokens, c.hidden_size), generator=gen,
                         device='cuda')
    runs, device = {}, {}
    for use_flash in (True, False):
        warm = []
        for _ in range(VIT_RUNS):
            model.zero_grad(set_to_none=True)
            flash_fwd.launches.update(bidirectional=0, causal=0)
            flash_bwd.launches.update(bidirectional=0, causal=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, _ = model(images, use_flash=use_flash)
            loss = (last.float() * weight).sum()
            loss.backward()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            warm.append(dt)
            n = (flash_fwd.launches['bidirectional'],
                 flash_bwd.launches['bidirectional'])
            want = (c.num_layers, c.num_layers) if use_flash else (0, 0)
            if n != want or flash_fwd.launches['causal'] \
                    or flash_bwd.launches['causal']:
                fail(f'DINOv2-L backward (use_flash={use_flash}): launches '
                     f'{flash_fwd.launches} forward, {flash_bwd.launches} '
                     f'backward; want {want[0]} bidirectional each')
        warm = sorted(warm[1:])
        runs[use_flash] = (loss.item(), warm, n, {
            k: p.grad.float() for k, p in model.named_parameters()})

        def once():
            model.zero_grad(set_to_none=True)
            out, _ = model(images, use_flash=use_flash)
            (out.float() * weight).sum().backward()
        device[use_flash] = device_per_step(torch, once, 2)[0]
    (f_loss, f_s, f_n, f_g), (p_loss, p_s, _, p_g) = runs[True], runs[False]
    # a key bias shifts every score of a query alike, which the softmax
    # ignores: its true gradient is 0 and both paths give rounding noise,
    # so it is held only inside the whole gradient
    rel = {k: ((f_g[k] - p_g[k]).norm()
               / p_g[k].norm().clamp(min=1e-30)).item() for k in p_g
           if not k.endswith('attention.key.bias')}
    total = (sum(((f_g[k] - p_g[k]) ** 2).sum() for k in p_g)
             / sum((p_g[k] ** 2).sum() for k in p_g)).sqrt().item()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    ok = total <= VIT_GRAD_TOL and all(v <= VIT_TENSOR_TOL
                                       for v in rel.values()) and all(
        bool(torch.isfinite(g).all()) for g in f_g.values())
    print(f'DINOv2-L forward + backward, full width ({c.num_layers} layers, '
          f'{pc.image_size}², B={VIT_BATCH}, bf16): use_flash '
          f'{_spread(f_s)}, plain attention {_spread(p_s)} (host clock, '
          f'{VIT_RUNS - 1} warm runs each), device kernel time '
          f'{device[True]:.1f} against {device[False]:.1f} ms '
          f'(torch.profiler, 2 runs each); '
          f'launches bidirectional fwd {f_n[0]}, bwd {f_n[1]}; loss '
          f'{f_loss:.6e} vs {p_loss:.6e}; {len(p_g)} parameter gradients, '
          f'whole-gradient rel err {total:.3e} (tol {VIT_GRAD_TOL}), worst '
          f'tensors but the key biases ' + ', '.join(f'{k} {v:.2e}'
                                                      for k, v in worst)
          + f' (tol {VIT_TENSOR_TOL}) {"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('DINOv2-L: the flash gradient disagrees with the plain one')
    del model, runs, f_g, p_g
    return f_n[1]


def check_probes(torch, timer, seed: int, card: str):
    """The H100 probes #10-#12 against their plain versions on the card at
    the probes' shapes, every kernel variant.  Returns {TPU kernel name:
    (max_abs_err, ms, plain_ms, (bound ms, bound by), library ms)}: #10 at
    down_proj, #11 summed over the four layer matmuls, #12 per layer
    (floor hb1, mxu hb1, mxu hb1 sb256)."""
    from groma_tpu_torch.benchmarks import (exp_decode_attn_variants as attn,
                                            exp_decode_matmul_m8 as m8,
                                            exp_int4_unpack as unpack)
    from groma_tpu_torch.ops.decode_attention import (
        int8_decode_attention_reference, p8_step)
    res = {}

    def held(name, got, want, tol, tol_txt):
        err = (got - want).abs()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
        ref_max = want.abs().max().item()
        print(f'{name}: max_abs_err {err.max().item():.3e}, rel '
              f'{err.max().item() / max(ref_max, 1e-30):.3e} of max|plain| '
              f'{ref_max:.3e} (tol {tol_txt}) {"ok" if ok else "FAIL"} '
              f'[{card}]')
        if not ok:
            fail(f'{name} disagrees with its plain version')
        return err.max().item()

    # #10: f32 sums in another order (split rows added with atomics); the
    # library yardstick is tinygemm with a scale of 1 and a zero of 8, which
    # takes the unsigned nibbles as they are (the output rounded to bf16)
    for shape, (kh, n) in unpack.SHAPES.items():
        x, p = unpack.make_inputs(kh, n, 'cuda', seed)
        want = unpack.unpack_matmul_reference(x, p)
        plain_ms = timer(lambda: unpack.unpack_matmul_reference(x, p))
        try:
            fn = _tinygemm(torch, x, p, torch.ones(
                (2 * kh // 256, n), device='cuda'), zero=8.0)
        except (RuntimeError, TypeError, AttributeError) as e:
            print(f'  library torch._weight_int4pack_mm: none (the repacking '
                  f'failed: {type(e).__name__}: '
                  f'{(str(e).splitlines() or [""])[0][:140]}) [{card}]')
            fn = None
        lib = fn and library_time(
            torch, timer, f'torch._weight_int4pack_mm (#10) {shape}, scale 1, '
            f'zero 8', fn, want, card)
        for v in unpack.VARIANTS:
            err = held(f'int4 unpack probe (#10) {v} {shape} KH={kh} N={n}',
                       unpack.unpack_matmul(x, p, v), want,
                       1e-5 * want.abs().max(), '1e-5*max|plain|')
            ms = timer(lambda: unpack.unpack_matmul(x, p, v))
            bnd = unpack.unpack_bound(kh, n)
            print(f'  kernel {ms * 1e3:.1f} us ({kh * n / ms / 1e6:.0f} GB/s '
                  f'packed), plain {plain_ms * 1e3:.1f} us, bound '
                  f'{bnd[0] * 1e3:.1f} us ({bnd[1]}) [{card}]')
            if shape == 'down_proj':
                res[f'_kern_{v.lower()}'] = (err, ms, plain_ms, bnd, lib)
        del x, p, want, fn

    # #11: integer dots exact, the same f32 epilogue; int4-a8's per-chunk
    # f32 sums in another order
    xs, _, forms = m8.make_inputs('cuda', seed)
    for key, fn, plain, form in (
            ('_w8a8_kernel', m8.w8a8_matmul, m8.w8a8_reference, 'int8'),
            ('_int4_a8_kernel', m8.int4_a8_matmul, m8.int4_a8_reference,
             'int4')):
        worst, ms, plain_ms, lib = 0.0, 0.0, 0.0, 0.0
        for k, kd, n in m8.SHAPES:
            x, w = xs[k], forms[form][k]
            want = plain(x, *w)
            worst = max(worst, held(
                f'M=8 probe (#11) {key} {k} K={kd} N={n}', fn(x, *w), want,
                1e-5 * want.abs().max(), '1e-5*max|plain|'))
            ms += timer(lambda: fn(x, *w))
            plain_ms += timer(lambda: plain(x, *w))
            if form == 'int8' and lib is not None:
                xq = m8.act_quant(x)[0]
                xp = torch.nn.functional.pad(
                    xq, (0, 0, 0, m8.INT_MM_ROWS - xq.shape[0]))
                acc = (xp.double() @ w[0].double()).float()
                t = library_time(torch, timer, f'torch._int_mm {k} (the int8 '
                                 f'product alone, x padded to 32 rows)',
                                 lambda: torch._int_mm(xp, w[0]), acc, card,
                                 rel_tol=0.0)
                lib = None if t is None else lib + t
        bnd = m8.layer_bound(form)
        print(f'  {key}, the four layer matmuls: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), '
              f'{m8.layer_bytes(form) / ms / 1e6:.0f} GB/s weights [{card}]')
        res[key] = (worst, ms, plain_ms, bnd,
                    lib if form == 'int8' else None)
    del xs, forms

    # #12 on two layers of KV (Lstack: one launch for both)
    q, k8, ks, v8, vs, bias = attn.make_inputs(2, 'cuda', seed)

    def layer(i):
        return q, k8[i], ks[i], v8[i], vs[i], bias

    def plain_and_tol(body, sblk, i):
        a = layer(i)
        if body == 'floor':
            want = attn.floor_reference(*a)
            return want, 1e-5 * want.abs().max(), '1e-5*max|plain|'
        if body == 'mxu':
            want = int8_decode_attention_reference(*a)
            step = p8_step(a[0], a[1], a[2], a[4], a[5])
        else:
            want = attn.mxu_sblk_reference(*a, sblk)
            step = attn.mxu_sblk_step(*a, sblk)
        return (want, 2 * step + 1e-5 * want.abs().max(),
                '2 p8 units + 1e-5*max|plain|')

    timed = {'floor hb1': 'k_floor', 'mxu hb1': 'k_mxu',
             'mxu hb1 sb256': 'k_mxu_sblk'}
    for name, body, hb, sblk, stacked in attn.variants():
        if stacked:
            got = attn.probe_decode_attention(q, k8, ks, v8, vs, bias, body,
                                              hb, sblk)
            err = max(held(f'decode attn probe (#12) {name}, layer {i}',
                           got[i], *plain_and_tol(body, sblk, i))
                      for i in range(2))
        else:
            err = held(f'decode attn probe (#12) {name}',
                       attn.probe_decode_attention(*layer(0), body, hb, sblk),
                       *plain_and_tol(body, sblk, 0))
        if name in timed:
            ms = timer(lambda: attn.probe_decode_attention(*layer(0), body,
                                                           hb, sblk))
            plain = attn.plain_version(body, sblk)
            plain_ms = timer(lambda: plain(*layer(0)))
            bnd = attn.layer_bound()
            print(f'  kernel {ms:.4f} ms per layer, plain {plain_ms:.4f} ms, '
                  f'bound {bnd[0]:.4f} ms ({bnd[1]}) [{card}]')
            res[timed[name]] = (err, ms, plain_ms, bnd, None)
    return res


def probes_main_path(card: str):
    """The three probes' entry points, as ``python -m
    groma_tpu_torch.benchmarks.<name>`` runs them, with the probe kernels'
    counts zeroed just before and read just after.  Returns {TPU kernel
    name: launches}."""
    from groma_tpu_torch.benchmarks import (exp_decode_attn_variants as attn,
                                            exp_decode_matmul_m8 as m8,
                                            exp_int4_unpack as unpack)
    unpack.unpack_matmul.launches.update({v: 0 for v in unpack.VARIANTS})
    m8.w8a8_matmul.launches = 0
    m8.int4_a8_matmul.launches = 0
    attn.probe_decode_attention.launches.update(
        {b: 0 for b in attn.BODIES})
    t0 = time.perf_counter()
    print(f'-- probe #10: python -m groma_tpu_torch.benchmarks.'
          f'exp_int4_unpack [{card}]', flush=True)
    unpack.main([])
    print(f'-- probe #11: python -m groma_tpu_torch.benchmarks.'
          f'exp_decode_matmul_m8 [{card}]', flush=True)
    m8.main([])
    print(f'-- probe #12: python -m groma_tpu_torch.benchmarks.'
          f'exp_decode_attn_variants [{card}]', flush=True)
    bad = attn.main([])
    if bad:
        fail(f'decode attention probe: parity gate failed for {bad}')
    n = {f'_kern_{v.lower()}': unpack.unpack_matmul.launches[v]
         for v in unpack.VARIANTS}
    n.update(_w8a8_kernel=m8.w8a8_matmul.launches,
             _int4_a8_kernel=m8.int4_a8_matmul.launches,
             k_floor=attn.probe_decode_attention.launches['floor'],
             k_mxu=attn.probe_decode_attention.launches['mxu'],
             k_mxu_sblk=attn.probe_decode_attention.launches['mxu_sblk'])
    print(f'probes: entry points ran in {time.perf_counter() - t0:.1f} s; '
          f'launches {n} [{card}]')
    if not all(n.values()):
        fail(f'a probe kernel was never launched by its entry point: {n}')
    return n


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


def serve_engine_full_width(torch, np, seed: int, card: str):
    """The production server, ``--engine --engine-slots 8 --quant_type int4
    --kv-bits 8 --paged-kv``, at full width: ENGINE_REQUESTS requests from
    as many threads at once through the port's ModelWorker.  Returns the
    int4 and paged kernels' launches."""
    import threading
    from groma_tpu_torch.ops.paged_attention import paged_int8_decode_attention
    from groma_tpu_torch.ops.quant4 import int4_matmul
    from groma_tpu_torch.serve.worker import ModelWorker

    t0 = time.perf_counter()
    worker = ModelWorker('random', seed=seed, quant_type='int4', kv_bits=8,
                         device='cuda', use_engine=True, engine_slots=8,
                         paged_kv=True)
    engine, cfg = worker.engine, worker.cfg
    torch.cuda.synchronize()
    st = engine.stats()
    print(f'engine: random full-width Groma-7B, int4 LLM, {st["max_slots"]} '
          f'slots, max_len {engine.max_len} ({engine._np_max} pages of 128), '
          f'{st["total_pages"]} pool pages, built in '
          f'{time.perf_counter() - t0:.1f} s; device memory '
          f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]')
    sessions = {}                   # client thread name -> its Session
    submit = engine.submit

    def recording_submit(*a, **kw):
        sess = submit(*a, **kw)
        sessions[threading.current_thread().name] = sess
        return sess
    engine.submit = recording_submit
    n_layers = cfg.llm.num_layers
    prompts = ('Locate the dog on the left in the image.',
               'What is in this picture? Give boxes for each object.',
               'Find the red car.', 'Where is the person holding a cup?')
    results = [None] * ENGINE_REQUESTS

    def client(i):
        request = {'image': random_image(np, seed + 10 + i,
                                         cfg.perceiver.image_size),
                   'prompt': prompts[i % len(prompts)],
                   'max_new_tokens': ENGINE_MAX_NEW, 'stream_chunk': 1}
        t_start = time.perf_counter()
        frames, t_first = [], None
        for f in worker.generate_stream(request):
            t_first = t_first or time.perf_counter()
            frames.append(f)
        results[i] = (frames, t_first - t_start, time.perf_counter())

    int4_matmul.launches = 0
    paged_int8_decode_attention.launches = 0
    threads = [threading.Thread(target=client, args=(i,), name=f'client{i}')
               for i in range(ENGINE_REQUESTS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    mm, att = int4_matmul.launches, paged_int8_decode_attention.launches
    st = engine.stats()
    engine.close()
    if any(r is None for r in results) or len(sessions) != ENGINE_REQUESTS:
        fail(f'engine: {sum(r is None for r in results)} requests did not '
             f'finish')
    vocab = cfg.vocab_size
    tokens = 0
    for i, (frames, ttft, _) in enumerate(results):
        sess = sessions[f'client{i}']
        final = frames[-1]
        problems = []
        if any(f['error_code'] != 0 for f in frames):
            problems.append(f'error frame {final}')
        toks = np.asarray(sess.tokens)
        if not (len(toks) and ((toks >= 0) & (toks < vocab)).all()):
            problems.append('token out of vocabulary range')
        boxes, mask = sess.vis['selected_boxes'], sess.vis['selected_mask']
        kept = boxes[mask]
        if not mask.any() or not np.isfinite(boxes).all() or not (
                (kept[:, 2:] > 0).all() and (kept >= 0).all()
                and (kept <= 1).all()):
            problems.append('malformed selected boxes')
        if any(not (np.isfinite(b).all() and len(b) == 4)
               for b in final.get('boxes', [])):
            problems.append('malformed boxes in the answer')
        if problems:
            fail(f'engine request {i}: ' + '; '.join(problems))
        tokens += len(toks)
        print(f'engine request {i}: error_code 0, {len(toks)} tokens, '
              f'{len(final["boxes"])} boxes in the answer, {int(mask.sum())} '
              f'regions kept; TTFT {ttft * 1e3:.1f} ms (client clock, queue '
              f'wait included), engine TTFT {sess.ttft * 1e3:.1f} ms [{card}]')
    steps = att // n_layers
    want_mm = (ENGINE_REQUESTS + steps) * (4 * n_layers + 1)
    problems = []
    if st['finished'] != ENGINE_REQUESTS or st['truncated'] != 0:
        problems.append(f'finished {st["finished"]}, truncated '
                        f'{st["truncated"]}')
    if st['free_pages'] != st['total_pages']:
        problems.append(f'{st["total_pages"] - st["free_pages"]} pages not '
                        f'returned')
    if st['nonfinite_logits']:
        problems.append(f'{st["nonfinite_logits"]} prefills or bursts with '
                        f'non-finite logits')
    if att % n_layers or steps != st['decode_steps'] or mm != want_mm:
        problems.append(f'launches int4_matmul {mm} (want {want_mm} = '
                        f'({ENGINE_REQUESTS} prefills + {steps} steps) x '
                        f'{4 * n_layers + 1}), paged attention {att} (want a '
                        f'multiple of {n_layers}, {st["decode_steps"]} steps)')
    if problems:
        fail('engine: ' + '; '.join(problems))
    print(f'engine: {ENGINE_REQUESTS} requests through {st["max_slots"]} '
          f'slots in {wall:.2f} s: {tokens} tokens, {tokens / wall:.1f} tok/s '
          f'aggregate, mean TTFT {st["mean_ttft_sec"] * 1e3:.1f} ms (engine '
          f'clock), {st["decode_steps"]} decode steps at '
          f'{st["decode_ms_per_step"]:.2f} ms/step (each step one token for '
          f'every live slot); every page returned; launches int4_matmul {mm}, '
          f'paged attention {att} [{card}]')
    del worker, engine
    return mm, att


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights and inputs')
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: this script runs only on the GPU')
    from groma_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    print(card)
    t0 = time.perf_counter()
    # the production library and the probes' own, built side by side
    probe_build = threading.Thread(target=cuda_lib.probe_library)
    probe_build.start()
    cuda_lib.library()
    probe_build.join()
    cuda_lib.probe_library()        # raises here if its build failed
    print(f'kernels built in {time.perf_counter() - t0:.1f} s')
    for info in (cuda_lib.build_info, cuda_lib.probe_build_info):
        print(f'  nvcc {info["seconds"]:.1f} s -> {info["path"]}')
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'  ptxas: {line.strip()}')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(args.seed)
    timer = Timer('cuda')
    mm_err, mm_ms, mm_bound, mm_lib = check_int8_matmul(torch, gen, timer,
                                                         card)
    att_err, att_ms, att_bound = check_decode_attention(torch, gen, timer,
                                                        card)
    int4_err, int4_ms, int4_bound, int4_lib = check_int4_matmul(
        torch, gen, timer, card)
    paged_err, paged_ms, paged_plain_ms, paged_bound = check_paged_attention(
        torch, gen, timer, card)
    flash = check_flash(torch, gen, timer, card)
    check_decode_megakernel(torch, gen, timer, args.seed, card)
    probes = check_probes(torch, timer, args.seed, card)
    del timer
    check_llm_path(torch, args.seed, card)
    check_int4_paged_path(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    check_stage3(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    flash_n = train_full_width(torch, np, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    if not all(flash_n):
        fail('a flash kernel of the training path was never launched')
    vit_bwd_n = vit_backward_full_width(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    mm_n, att_n = serve_full_width(torch, np, args.seed, card)
    if not (mm_n and att_n):
        fail('a kernel of the served path was never launched')
    gc.collect()
    torch.cuda.empty_cache()
    int4_n, paged_n = serve_engine_full_width(torch, np, args.seed, card)
    if not (int4_n and paged_n):
        fail('a kernel of the engine path was never launched')
    gc.collect()
    torch.cuda.empty_cache()
    mk_n, mk_times = decode_megakernel_path(torch, Timer('cuda'),
                                            args.seed, card)
    if not mk_n:
        fail('the decode megakernel was never launched on its path')
    gc.collect()
    torch.cuda.empty_cache()
    probe_n = probes_main_path(card)
    if 'jax' in sys.modules or 'flax' in sys.modules:
        fail('jax was imported')

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library):
        return {'name': name, 'route': 'cuda',
                'source': f'groma_tpu_torch/csrc/{source}',
                'replaces': replaces, 'launches': launches,
                'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bnd[0], 'bound_by': bnd[1],
                'library_ms': library}

    def flash_entry(name, key, source, replaces, n):
        err, ms, plain_ms, bnd, library = flash[key]
        return entry(name, source, replaces, n, err, ms, plain_ms, bnd,
                     library)

    print(json.dumps({'kernels': [
        entry('int8_matmul', 'int8_matmul.cu', 'groma_tpu/ops/quant.py:52',
              mm_n, mm_err, *mm_ms, mm_bound, mm_lib),
        entry('int8_decode_attention', 'decode_attention.cu',
              'groma_tpu/ops/decode_attention.py:32', att_n, att_err,
              *att_ms, att_bound, None),
        flash_entry('flash_fwd (bidirectional)', 'bidirectional',
                    'flash_attention_fwd.cu',
                    'groma_tpu/ops/flash_attention.py:68', flash_n[0]),
        flash_entry('flash_fwd (causal)', 'causal',
                    'flash_attention_fwd.cu',
                    'groma_tpu/ops/flash_attention.py:222', flash_n[1]),
        flash_entry('flash_bwd (causal)', 'backward',
                    'flash_attention_bwd.cu',
                    'groma_tpu/ops/flash_attention.py:527', flash_n[2]),
        entry('int4_matmul', 'int4_matmul.cu', 'groma_tpu/ops/quant4.py:85',
              int4_n, int4_err, *int4_ms, int4_bound, int4_lib),
        entry('paged_int8_decode_attention', 'paged_attention.cu',
              'groma_tpu/ops/paged_attention.py:51', paged_n, paged_err,
              paged_ms, paged_plain_ms, paged_bound, None),
        entry('decode_megakernel', 'decode_megakernel.cu',
              'groma_tpu/ops/decode_megakernel.py:192', mk_n, *mk_times[:3],
              mk_times[3:], None),
        flash_entry('flash_bwd (bidirectional)', 'bidirectional backward',
                    'flash_attention_bwd.cu',
                    'groma_tpu/ops/flash_attention.py:453', vit_bwd_n),
        *[entry(f'{name} ({key})', source, replaces, probe_n[key],
                *probes[key][:3], probes[key][3], probes[key][4])
          for key, name, source, replaces in PROBE_KERNELS],
    ]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
