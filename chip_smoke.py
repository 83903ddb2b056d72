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
    backward, torch._int_mm, the backend named): the int8 matmul (served
    path; its decode tile at M = 1, 4, 8, 40 (the engine's verify), 100
    and 192 (a prefill chunk) against the scale-after
    plain version, its wgmma prefill tile at M = 256, 300 and 2048 against
    the dequantize-first one, each at the four layer shapes and the padded
    head, the ragged head and an odd K at M = 1 and 300, every case called
    twice, bitwise equal, and nearer its own route than the other; ptxas's
    registers and spills and any wgmma serialization warning of
    int8_matmul.cu, each a failure; beside torch._weight_int8pack_mm at
    M = 1, 8, 40, 192 and 2048 and a bf16 torch.matmul on dequantized copies at
    M = 2048), the decode attention (served path: B = 1 and 4 at S = 1024
    and 2112, B = 2 at a ragged S = 1001, the served stream's own mask, an
    all-masked and a last-slot-only row, the per-layer path's B=8 at
    S=1024; every case called twice, bitwise equal; the cluster size, CTAs
    and rows read, and ptxas's registers and spills, a spill a failure;
    timed with the L2 flushed and not), the packed-int4 matmul
    (each
    of the int4 tree's five shapes at M=1 and M=8, the engine's decode,
    through the decode tile, and at M=9, 200 and 2048, a prefill, through
    the wgmma prefill tile; at M=1, 8 and 2048 beside
    torch._weight_int4pack_mm, at M=2048 also beside torch.matmul in bf16
    on a dequantized copy of the weights; both tiles also at a ragged N
    (N % 128 = 64) and with scales 2^0 to 2^10 apart from block to block;
    every case called twice, bitwise equal; ptxas's registers and spills
    for both tiles and any wgmma serialization warning (a failure); at
    down_proj the bound is also shown to flag a wrong scale on the block
    that straddles K/2) and the paged decode
    attention (8 slots, ragged lengths up to 2432, shuffled
    pages, a frozen row, and the engine's own lengths of 400 to 600; each
    called twice, bitwise equal; ptxas's registers and spills), the
    flash-attention forward (bidirectional at the
    ViT's (2, 16, 1025, 64), also with a fully masked row and at Sq != Skv;
    causal at the LLM's (2, 32, 2048, 128) under a grounded key mask and at
    S=1500; each head dim in each mode; each called twice, out and lse
    bitwise equal; #3 and #4 with their TFLOP/s, share of the bound and
    ratio to SDPA), the backward (bidirectional at the ViT's shape
    under a grounded key mask, also with a fully masked row and at
    Sq != Skv; causal at the LLM's and at S=1500; each called twice, dk and
    dv bitwise equal, and #5 and #6 with their TFLOP/s, share of the bound
    and ratio to SDPA's backward), the probes' kernels (#10-#12, every
    variant at the probes' shapes), and the all-layer decode
    megakernel at full width and 2 layers (B=8, a 1024-slot cache written
    at slot 700, a ragged mask and a fully masked row: the hidden state,
    the written column within one int8 unit, every other cache byte
    unchanged, two calls on copies of the cache bitwise equal; ptxas's
    registers and spills, a failure if it spills; the same on plans of 114
    and 78 CTAs, two attention pairs a CTA, at slot 64 beside a fully
    masked row; a misaligned mask refused); then the int8 LLaMA path
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
    both int8 kernels' launches on the device must be exactly the count
    the path implies (the int8 matmul 4L + 1 a forward, of them the
    prefill tile 4L a prefill: the wrappers' counts, less those made while
    a step was captured, plus every replay's), and the slots the last
    decode forward's attention read.  Each decode runs as one captured
    step replayed (utils/graphs.StepGraph); on request 0 the same step
    also runs eagerly on a copy of the state (GraphTwin): tokens bitwise
    equal, ms a token, device time and busy share of both, and the
    kernels of a profiled replay against the launches the capture
    counted.  Every prefill is a replay of the generator's prefill graph
    (utils/graphs.CallGraph, one a (B, S)), captured at the first request
    and never again; on request 0 the replay is held against its eager
    twin (PrefillTwin: the same body eagerly on the same inputs and a copy
    of the cache; every output and cache byte bitwise equal, a control
    fed a mirrored image refused, launches a replay equal to the eager
    prefill's), with both's host and device ms, the capture's ms, the
    pool's GiB and the device operations a replay.  Then one warm prefill
    alone and the same request with 9 new tokens under torch.profiler:
    the prefill's device time by kernel against its host clock, and the
    device time a decode token;
 5b. on the same weights, JAX's benchmarked configuration and
    speculation (the W8A8 product and the int8 convs were held bitwise to
    their plain versions in phase 2, and their quantization and rescale to
    CPU copies: the four layer matmuls at M = 2048 and 576 on the K-major
    copy and the stored layout, beside #1's prefill tile and the int8 and
    bf16 bounds; the fuse convs' pieces at 128², 64² and 32² and the RoI
    head's conv over 100 RoIs, beside cuDNN's bf16 conv): JAX's end-to-end
    REC run (bench_e2e.py --w8a8 --int8vision, B=1: a 640-slot REC
    stream, vision with #3 and the int8 convs, check_stream_capacity and
    compact_stream to 576, the W8A8 prefill, 3 greedy decode steps; the
    prefill one captured graph, its replay against its eager twin; ms
    per image, device time, exact launches); QuantGenerator(kv_bits=8,
    use_flash=True, w8a8_prefill=True) under GromaConfig(vision_int8=True)
    on the three requests (#3 24 and #4 32 launches a request, exact; the
    first logits against the weight-only prefill's, a cosine of at least
    W8A8_COSINE_MIN; request 0's replay against its eager twin), and
    three warm prefills under torch.profiler (that configuration, flash
    alone, the served one; host clock against device time);
    QuantGenerator(kv_bits=8,
    spec_lookahead=4) on the same requests (verify calls, accepted a call,
    ms/token; the tokens equal to the sequential greedy ones, or first
    different at a near-tie: the logits the verify picked its token from,
    as its captured step recorded them, and the sequential decode's,
    recomputed, at most SPEC_LOGIT_DIFF_MAX apart, each token the maximum
    of its own path's logits and within twice that difference of the
    other's, the sequential top-2 gap below it), and
    its verify step's replays
    against the eager step on a copy of the state (bitwise, busy share,
    launches a replay);
 6. the unquantized path, the default of every JAX entry point
    (--quant_type none): first the LLaMA forward at full width and two
    layers, bf16 weights and cache, on the card against the CPU (a prefill,
    scalar-index and per-row decode steps); then at full Groma-7B width
    with random weights from --seed (the LLM trunk stored in bf16, a bf16
    KV cache of max_seq_len + 64 slots) the port's default ModelWorker
    answers 3 requests through Generator, the third sampled at
    UNQUANT_TEMPERATURE, each checked, none launching a kernel of the port
    (as JAX's default launches no Pallas kernel), the first against the
    eager step (GraphTwin, as in phase 5) and its prefill graph's replay
    against the eager twin (PrefillTwin); Generator(use_flash=True)
    on the same weights runs one prefill, its replay launching exactly one
    bidirectional flash kernel per ViT layer and one causal one per LLM
    layer as its eager twin does, its first logits against the dense
    prefill's; the prefill's device time by kernel
    (dense and flash) and the device time a decode token under
    torch.profiler; then, the model freed, the --engine worker (qp=None,
    UNQUANT_ENGINE_SLOTS slots) answers as many concurrent requests:
    every one finished, aggregate tok/s, TTFT, ms per decode step; then
    one more request, its prefill (a replay of the engine's prefill_one
    graph) and its first burst against the eager ones;
 7. the production server at full width (--engine --engine-slots 8
    --quant_type int4 --kv-bits 8 --paged-kv, max_len 2432): the port's
    ModelWorker answers ENGINE_REQUESTS requests sent from as many threads
    at once, each checked; then every request finished, none truncated,
    every page back in the pool, and exact launch counts (paged attention
    L per decode step, int4 matmul 4L + 1 per prefill and per step, of
    them the prefill tile 4L per prefill), with TTFT per request, each
    prefill's time, aggregate tok/s and ms per decode step (launches
    counted on the device, as in phase 5; one prefill graph captured, its
    warm-up counted); then one more request per
    slot, ENGINE_PROFILED_BURSTS of whose bursts with every slot live run
    under torch.profiler (device time a step, the slots' kv lengths); then
    one more request, its prefill and first burst against the eager ones;
 7b. the serving stack on JAX's REC engine cell (bench_engine.py: 8 slots,
    bursts of 24, prefill chunks of 192, 640-slot REC streams, 48 new
    tokens, no EOS) at full width, int8 LLM and KV: the port's worker
    started as `--engine --prefill-chunk 192 --spec-lookahead 4` (the
    flags reach its engine; the engine then takes the cell's burst and
    stream), the port's controller and web front on localhost, the worker
    registered by heartbeat; STACK_REQUESTS requests from as many threads,
    one through the web front (a PNG decoded without PIL), the rest
    dispatched by the controller, each checked; then the same requests
    in-process through the one-shot engine and the chunked one: exact
    launch counts of #1 and #2 (#1 4L a chunk at M = 192, last_idx // 192
    + 1 chunks a request), both engines' logits as their captured steps
    recorded them, at every token up to the first that parts: each token
    the maximum of its own logits, the first logits within
    STACK_FIRST_REL_MAX of max|one-shot| (and a cosine), the later ones
    within STACK_CHUNK_DIFF_MAX, a parted token at a near-tie; the longest
    gap between two bursts a live stream sees, TTFT, tok/s and ms a
    decode step of both (max_len 768); the chunk step's replays against
    the eager step on a copy of its state (bitwise); the verify step on
    copies of the live state of an engine with --spec-lookahead 4 (max_len
    896; B = 8, G = 4, teacher-forced greedy drafts): acceptance, the
    written slots against the sequential decode's, a wrong second draft on
    every row that accepted its first, a finished row, replay against
    eager (bitwise); the one-shot engine's prefill_one graph, and the
    chunked one's prepare_one and last_logits graphs (the control of the
    last: another position of the chunk), each replay against its eager
    twin; the warm engines' drives capture no prefill graph;
 8. the decode benchmark's path (bench_decode_quant.measure_megakernel) at
    full depth: the random full-width Vicuna-7B int4 tree from --seed,
    B=8, a 512-token random prompt prefilled per layer into a 1024-slot
    int8 cache (timed; its 4L layer matmuls at M=4096 through the prefill
    tile, counted), MEGAKERNEL_STEPS greedy steps through
    quant_llama_decode_megakernel (exactly one megakernel launch each) as
    one captured step replayed, the cache slot a device word, checked
    against the eager step on a copy of the state (GraphTwin),
    then the same tokens teacher-forced through the per-layer
    quant_llama_forward on a copy of the cache (int4 matmul 4L and decode
    attention L launches a step); hidden states agree every step; ms/step
    and tok/s of both, PROFILED_STEPS more steps of each under
    torch.profiler (device time and operations a step), and the kernel
    alone beside its plain version and its bound (two calls bitwise equal;
    its time below the per-layer path's device time a step, or the phase
    fails), and one launch with %globaltimer stamps: how its time splits
    among the phases' work, the idle tails of uneven rounds and the grid
    barriers, and the count of grid barriers a step.
 9. DINOv2-L at full width (24 layers, 448², B=2, bf16 on f32 master
    weights) forward and backward through the port's Dinov2Model with
    use_flash=True, the path of the bidirectional backward (#6): exactly
    24 launches of its forward and of its backward, and the parameter
    gradient of a fixed scalar against the same model with use_flash=False
    on the card;
 10. the H100 probes #10-#12 (groma_tpu_torch/benchmarks; each kernel
    variant was held against its plain version in phase 2): each probe's
    entry point as `python -m groma_tpu_torch.benchmarks.<name>` runs it,
    printing the probe's table.
 11. the detection stage (stage 1, scripts/det_pretrain.sh) at full width
    (DINOv2-L at 448 frozen, DDETR d=256, 6+6 layers, 300 queries, one
    level), random f32 weights from --seed, B=8 (the script's 64 cut for
    memory and time) on seeded synthetic 640x480 PNGs with 10 to 50 boxes
    each from a coco_box and an sa1b_box source: train_det through its
    entry point for an epoch (4 steps) and a resume for one more (losses
    finite, the ViT bitwise unchanged, every other tensor moved, peak
    memory), its step function's warm ms/step and, under torch.profiler,
    device busy share and top kernels, both matchers' ms per step at these
    shapes, evaluate_detector's COCO summary on 8 images and run_ddetr on
    the export; then a twin at 2 ViT and 2+2 DDETR layers: one step on the
    card against the CPU (the same matches, every loss, every trainable
    gradient, within the DET_TWIN limits).  No kernel runs on this path.
 12. GQA, DINOv2-giant, the evaluation kits and FSDP.  In phase 2, #1
    and #7 at the GQA qkv width
    (K, N) = GQA_QKV (32 query heads over 8 KV heads) at M = 1, 8 and
    2048 against their plain versions (twice, bitwise equal) with bound
    and library times; after the int8 path, the GQA LLaMA path at full
    width and 2 layers, int8 and int4 weights, prefill and decode over the
    int8 cache (dequantized, heads repeated, #2 never launched) against
    the CPU; after DINOv2-L, DINOv2-giant (hidden 1536, 40 layers, 24
    heads, SwiGLU) forward at 448² with use_flash against the plain
    forward (40 flash launches; each layer, and the whole forward) and #3
    at its shape; after the engine, GQA serving at GromaConfig() widths
    with 8 KV heads, 32 layers: QuantGenerator(kv_bits=8) on int8 weights
    (2 requests) and the contiguous BatchEngine on int4 weights (8 slots,
    GQA_REQUESTS requests), GQA_MAX_NEW tokens each, the prefill tiles
    exactly 4L a prefill, #2 and #8 never; last, region captioning through
    eval/region_cap's CLI on REGION_CAP_IMAGES PNGs and merge_and_score,
    the LLaVA-bench kit (answer_questions on LLAVA_QUESTIONS carried
    questions, the stub judge over its answers and the carried answer
    files), both on random full-width Groma-7B, and train_vl's step under
    a 1-rank NCCL process group with FSDP over a (1, 1) mesh against the
    same step without a group (stage 3, 2 LLM layers: loss within
    FSDP_LOSS_TOL, the trained leaves' gradients and updates within the
    FSDP_*_TOL relative Frobenius limits, controls that must miss them,
    the same flash launches).
 13. tensor parallelism at tp = 2 on the one card: two processes spawned
    on cuda:0 under a gloo group (NCCL refuses two ranks on one device;
    the tp collectives are all-reduces, which gloo carries for CUDA
    tensors), every time of it one card time-shared by two ranks, not a
    multi-card time.  Groma-7B at GromaConfig() widths served through
    Generator(use_flash=True), each rank on its 16 query heads and half
    the vocabulary, against the same weights without a group (the
    prefill's last hidden and first logits, the tokens, #3 and #4's
    launches and shapes a rank, the eager decode, and the eager prefill:
    a gloo group's collectives cannot be captured, and the reference
    without a group runs eagerly too); then train_vl's
    stage-3 step at 2 LLM layers cut over tp against two steps without a
    group and one with the LLM in f32, with four controls.  In phase 2,
    #4 and #5 also at a rank's local heads, (1, 16, 2048, 128).
Then one JSON line with the twenty-six kernel rows, the int8 and the int4
matmuls' two tiles apart (launches: the training
path's for the forward flash kernels and the causal backward, the DINOv2-L
phase's for the bidirectional backward, the served path's for the int8
ones, the engine's for the int4 and paged ones, the decode path's for the
megakernel, the probes' entry points' for theirs; the GQA rows' from the
GQA serving runs, DINOv2-giant's from its forward, the tp rows' from both
ranks of phase 13), and as the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero and prints
no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import threading
import time

try:
    from groma_tpu_torch.utils.graphs import set_launch_counts
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
# #1's decode tile (M < 256): 40 is the engine's verify (8 slots x 5
# tokens), 192 a chunk of the chunked prefill
INT8_DECODE_ROWS = (1, 4, 8, 40, 100, 192)
INT8_PREFILL_ROWS = (256, 300, 2048)    # #1's prefill tile
INT8_PREFILL_M = 2048     # M of a served prefill: one stream of max_seq_len
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
# the engine's own lengths: positions are stored compactly, so a slot holds
# its prompt's valid tokens (about 520 here) plus what it decoded; tables
# are max_len's 19 pages wide
ENGINE_PAGED_LENGTHS = (400, 430, 460, 490, 520, 550, 580, 600)
ENGINE_TABLE_PAGES = 19
SERVED_PROMPTS = ('Locate the dog on the left in the image.',
                  'What is in this picture? Give boxes for each object.',
                  'Find the red car.')
ENGINE_REQUESTS = 12       # through 8 slots: 4 wait and join mid-decode
ENGINE_MAX_NEW = 32
ENGINE_PROFILED_BURSTS = 2  # of 8 steps each, every slot live
MAX_NEW_TOKENS = 32        # the 2112-slot cache leaves 64 after prefill
# the unquantized path (--quant_type none): the third request is sampled.
# Generator(use_flash=True) against the dense Generator: the dense ViT
# rounds its scores to bf16 where the flash kernel keeps f32, and the
# region pool is ordered by scores that move with that, so the two streams
# differ (measured on an H100: first logits 4.2e-2 and 4.3e-2 apart, 96 %
# of the pool's slots reordered).  The LLM alone, flash against dense on
# the flash path's own stream: p is rounded to bf16 before its sum in the
# kernel and after it in the dense path, and 32 layers of random weights
# carry that (measured 2.9e-2).  Both are drift limits over 32 layers, as
# MEGAKERNEL_PATH_TOL is; #4 itself is held tightly in phase 2.
UNQUANT_TEMPERATURE = 0.7
UNQUANT_FLASH_TOL = 0.1       # first logits, relative to max|logits|
UNQUANT_LLM_FLASH_TOL = 0.1   # LLM hidden, relative to max|hidden|
UNQUANT_ENGINE_SLOTS = 4
# W8A8 and speculation (phase 5b): the W8A8 product at the served
# prefill's M and the compacted REC stream's; the int8 vision convs'
# shapes (name, B, C, H = W, calls an image: 5 fuse rounds, one RoI head);
# JAX's end-to-end REC configuration (benchmarks/bench_e2e.py: a 640-slot
# stream compacted to 576, 3 decode steps); the W8A8 generator's first
# logits against the weight-only prefill's (a layout or scale fault gives
# a cosine near 0); speculation's lookahead and the verify twin's steps
W8A8_ROWS = (2048, 576)
W8A8_CONV_CASES = [(f'fuse {hw}x{hw}, {piece}', 1, c, hw, 5)
                   for hw in (128, 64, 32)
                   for piece, c in (('kept channels', 512),
                                    ('from the coarser level', 256),
                                    ('from the finer level', 256))] + [
    ('RoI head (pconv)', 100, 3072, 14, 1)]
# the plain conv also runs on CPU copies (int32 products) for the cases of
# at most this many input elements: the 32² fuse pieces
W8A8_CONV_CPU_ELEMENTS = 32 * 32 * 512
REC_SEQ_LEN, REC_PREFILL_LEN, REC_DECODE_STEPS = 640, 576, 3
REC_RUNS = 3
W8A8_COSINE_MIN = 0.9
SPEC_LOOKAHEAD = 4
SPEC_TWIN_STEPS = 4
# the most |verify - decode| logit difference a sound verify forward shows
# where speculative and sequential tokens part: the int8-cache verify
# attends through the dequantized cache, the decode through #2.  On an
# H100 at full width a sound verify showed 0.070 to 0.094 (this script,
# where tokens parted) and 0.072 to 0.094 (benchmarks/spec_divergence.py,
# also with the chunk written one slot early), one with its rope positions
# one too far 0.138 to 0.171; the logits are bf16-valued: 4 of their steps
# of 2^-5 at the served logits' magnitude
SPEC_LOGIT_DIFF_MAX = 0.125
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


def _spills(summary: str) -> bool:
    """Whether a ptxas summary reports any bytes of spill stores or loads."""
    import re
    return any(int(n) for n in re.findall(r'(\d+) bytes spill', summary))


def check_int8_matmul(torch, gen, timer, card):
    """#1's two tiles against their plain versions: the decode tile
    (int8_matmul_reference, the scale after the dot) at M = 1, 4, 8 and
    100, the prefill tile (int8_matmul_dense_reference, the weights
    dequantized to bf16 first) at M = 256, 300 and 2048, each at the four
    layer shapes and the padded head; the ragged head (N = 32114, padded per
    call) and an odd K (4100, padded per call) at M = 1 and 300; every case
    called twice, bitwise equal, and nearer its own route's plain version
    than the other route's.  ptxas's
    registers and spills of both tiles and any wgmma serialization warning
    of int8_matmul.cu (each a failure).  Beside the four layer matmuls at
    M = 1, 8 and 2048: torch._weight_int8pack_mm (bf16 scales) and, at
    M = 2048, a bf16 torch.matmul on dequantized copies.  Returns the
    decode tile's tuples at M = 1 and M = 8 and the prefill tile's at M =
    2048: (max_abs_err over the tile's cases, (kernel ms, plain ms), (bound
    ms, bound by), library ms), the sums over the four layer matmuls."""
    from groma_tpu_torch.ops import cuda_lib
    from groma_tpu_torch.ops.quant import (DENSE_MIN_ROWS, decode_plan,
                                           dequantize_weight, int8_matmul,
                                           int8_matmul_dense_reference,
                                           int8_matmul_reference,
                                           prefill_plan)
    dev = 'cuda'
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = cuda_lib.build_info.get('log', '')
    for tile, kernel in (('decode', 'int8_decode_kernel'),
                         ('prefill', 'int8_prefill_kernel')):
        summary = _ptxas_summary(log, kernel)
        print(f'int8_matmul {tile} tile, ptxas: {summary} [{card}]')
        if _spills(summary):
            fail(f'ptxas spilled registers of {kernel}')
    serialized = _ptxas_wgmma_warnings(log, 'int8_matmul.cu')
    print(f'int8_matmul prefill tile, ptxas wgmma serialization warnings: '
          f'{"; ".join(serialized) or "none"} [{card}]')
    if serialized:
        fail('ptxas serialized the wgmma products of int8_prefill_kernel')
    shapes = [(name, k, n) for name, (k, n) in INT8_MATMUL_SHAPES.items()
              if 'ragged' not in name]
    ragged = INT8_MATMUL_SHAPES['lm_head (ragged N)']
    cases = [(m, *shape) for m in INT8_DECODE_ROWS + INT8_PREFILL_ROWS
             for shape in shapes]
    cases += [(m, 'lm_head (ragged N)', *ragged) for m in (1, 300)]
    # K not a multiple of 8: x's rows are not 16-byte pitched for TMA, so
    # the wrapper pads K (and x) per call
    cases += [(m, 'odd K', 4100, 4096) for m in (1, 300)]
    worst = {False: 0.0, True: 0.0}      # by tile: M >= 256
    # M -> [kernel, plain, bound, library, bound by, bf16 matmul] ms over
    # the four layer matmuls
    sums = {}
    for m, name, k, n in cases:
        dense = m >= DENSE_MIN_ROWS
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4
        plain, other = (int8_matmul_dense_reference, int8_matmul_reference)
        if not dense:
            plain, other = other, plain
        got = int8_matmul(x, w, scale)
        again = int8_matmul(x, w, scale)
        stable = bool(torch.equal(got, again))
        got = got.float()
        want = plain(x, w, scale).float()
        err = (got - want).abs()
        # f32 sums in another order, then one bf16 rounding each: at most
        # one bf16 step (2^-7 relative) apart, plus f32 noise
        tol = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
        # the two routes round differently (bf16 weights, or the scale
        # after the dot): the tile must follow its own
        mean_own = err.mean().item()
        mean_other = (got - other(x, w, scale).float()).abs().mean().item()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all()) \
            and stable and mean_own < mean_other
        max_err = err.max().item()
        worst[dense] = max(worst[dense], max_err)
        ms = timer(lambda: int8_matmul(x, w, scale))
        plain_ms = timer(lambda: plain(x, w, scale))
        b_ms, bound_by = bound(k * n + 4 * n + 2 * m * (k + n),
                               2 * m * k * n)
        lib = None
        if name in LAYER_MATMULS and m in (1, 8, 40, 192, INT8_PREFILL_M):
            # bf16 scales (the plain versions' are f32)
            w_t = w.T.contiguous()
            lib = library_time(
                torch, timer, f'torch._weight_int8pack_mm M={m} {name}',
                lambda: torch._weight_int8pack_mm(
                    x, w_t, scale.to(torch.bfloat16)), want, card)
            del w_t
        # a dense bf16 product of the same size on a dequantized copy of
        # the weights (the route this tile replaces, without its copy)
        dense_ms = 0.0
        if m == INT8_PREFILL_M and name in LAYER_MATMULS:
            wd = dequantize_weight(w, scale)
            dense_ms = timer(lambda: torch.matmul(x, wd))
            print(f'  torch.matmul bf16 on a dequantized copy M={m} {name}: '
                  f'{dense_ms:.4f} ms ({2 * m * k * n / dense_ms / 1e9:.1f} '
                  f'TFLOP/s) [{card}]')
            del wd
        if name in LAYER_MATMULS:
            acc = sums.setdefault(m, [0.0, 0.0, 0.0, 0.0, bound_by, 0.0])
            acc[0] += ms
            acc[1] += plain_ms
            acc[2] += b_ms
            acc[3] = None if lib is None or acc[3] is None else acc[3] + lib
            acc[5] += dense_ms
        ref_max = want.abs().max().item()
        if dense:
            rate = (f'{2 * m * k * n / ms / 1e9:.1f} TFLOP/s, '
                    f'{100 * b_ms / ms:.1f} % of the bound {b_ms:.4f} ms '
                    f'({bound_by}); plan {prefill_plan(m, n, sms)} (ctas, '
                    f'token tiles, column tiles)')
        else:
            rate = (f'{k * n / ms / 1e6:.1f} GB/s weights, '
                    f'{100 * b_ms / ms:.1f} % of the bound {b_ms:.4f} ms '
                    f'({bound_by}); plan {decode_plan(m, k, n, sms)} (split '
                    f'rows, splits)')
        print(f'int8_matmul {"prefill" if dense else "decode"} tile M={m} '
              f'{name} K={k} N={n}: max_abs_err {max_err:.3e}, rel '
              f'{max_err / ref_max:.3e} of max|plain| {ref_max:.3e} (tol '
              f'2^-7*|plain| + 1e-4*max|plain|), mean |err| {mean_own:.3e} '
              f'(against the other route\'s plain version {mean_other:.3e}) '
              f'{"ok" if ok else "FAIL"}, two calls '
              f'{"bitwise equal" if stable else "DIFFER"}; kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, {rate} [{card}]')
        if not ok:
            fail(f'int8_matmul disagrees with its plain version at M={m} '
                 f'{name} K={k} N={n}, follows the other route, or two '
                 f'calls differ')
        del x, w, scale, got, want, err, again
    for m, (ms, plain_ms, b_ms, lib, by, dense_ms) in sums.items():
        lib_txt = 'none' if lib is None else f'{lib:.4f} ms'
        ratio = '' if lib is None else f', {ms / lib:.3f} x the library'
        dense = (f', torch.matmul bf16 on dequantized copies {dense_ms:.4f} '
                 f'ms ({ms / dense_ms:.3f} x)' if dense_ms else '')
        print(f'int8_matmul M={m}, the four layer matmuls: kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), '
              f'{100 * b_ms / ms:.1f} % of the bound, '
              f'torch._weight_int8pack_mm {lib_txt}{ratio}{dense} [{card}]')

    def result(m):
        ms, plain_ms, b_ms, lib, by = sums[m][:5]
        return worst[m >= DENSE_MIN_ROWS], [ms, plain_ms], (b_ms, by), lib
    return result(1), result(8), result(INT8_PREFILL_M)


def _served_valid(torch, s: int, decoded: int):
    """The served stream's kept slots at a decode step: expand_template of
    SERVED_PROMPTS[0] in the worker's conversation template (the stub
    tokenizer at GromaConfig widths), padded to max_seq_len, then
    ``decoded`` tokens from slot max_seq_len on."""
    from groma_tpu_torch.config import GromaConfig
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu_torch.serve.worker import expand_request
    cfg = GromaConfig()
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    t = expand_request(StableStubTokenizer(cfg.llm.vocab_size,
                                           cfg.max_seq_len),
                       spec, {'prompt': SERVED_PROMPTS[0]})
    valid = torch.zeros(s, dtype=torch.bool)
    valid[:cfg.max_seq_len] = torch.from_numpy(t['valid'])
    valid[cfg.max_seq_len:cfg.max_seq_len + decoded] = True
    return valid


def _read_rows(bias):
    """Per row of a (B, 1, 1, S) bias, the slots the decode-attention kernel
    reads: those kept (bias above -1e29), or all S where none is."""
    kept = (bias[:, 0, 0] > -1e29).sum(-1)
    return [int(k) if k else bias.shape[-1] for k in kept.tolist()]


def _kernel_ptxas(card, kernel: str):
    """Print ptxas's registers and spills of ``kernel``; a spill fails."""
    from groma_tpu_torch.ops import cuda_lib
    summary = _ptxas_summary(cuda_lib.build_info['log'], kernel)
    print(f'{kernel}: ptxas {summary} [{card}]')
    if _spills(summary):
        fail(f'{kernel} spills registers: {summary}')


def check_decode_attention(torch, gen, timer, card):
    """#2 against its plain version: the chip_smoke shapes with a valid
    prefix per row (B = 1, 4; S = 1024, 2112; B = 2 at S = 1001, not a
    multiple of 4), the served stream's own mask
    at B=1, S=2112 (expand_template of a chip_smoke prompt plus the decoded
    tail), a row with every slot masked and one whose only kept slot is its
    last, and the per-layer batched path's B=8, S=1024.  Every case is
    called twice, bitwise equal.  Returns (max_abs_err, (kernel ms, plain
    ms), (bound ms, bound by)) at the served mask (no PyTorch call computes
    int8-KV attention with p requantized)."""
    from groma_tpu_torch.models.llama_quant import _quantize_tokens
    from groma_tpu_torch.ops.decode_attention import (
        decode_attention_plan, int8_decode_attention,
        int8_decode_attention_reference, p8_step)
    dev = 'cuda'
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _kernel_ptxas(card, 'int8_decode_attention_kernel')

    def prefix(b, s):
        # a valid prefix per row, the tail masked as unwritten slots
        return torch.arange(s)[None] < torch.tensor(
            [s - 64 - 17 * i for i in range(b)])[:, None]
    served = _served_valid(torch, 2112, MAX_NEW_TOKENS)
    odd = served[None].repeat(3, 1)
    odd[1] = False                   # every slot masked: uniform p
    odd[2] = False
    odd[2, -1] = True                # only the last slot kept
    cases = [('valid prefix', prefix(b, s)) for b in (1, 4)
             for s in (1024, 2112)]
    cases += [('ragged S, its scales and bias by plain loads',
               prefix(2, 1001)),
              ('served mask', served[None]),
              ('served, all-masked and last-slot rows', odd),
              ('per-layer path', torch.arange(1024)[None] < torch.tensor(
                  [DECODE_PROMPT + 8 * i
                   for i in range(DECODE_BATCH)])[:, None])]
    worst, result = 0.0, None
    for label, valid in cases:
        b, s = valid.shape
        h, d = 32, 128
        q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k8, ks = _quantize_tokens(
            torch.randn((b, h, s, d), generator=gen, device=dev))
        v8, vs = _quantize_tokens(
            torch.randn((b, h, s, d), generator=gen, device=dev))
        bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].to(dev)
        args = (q, k8, ks, v8, vs, bias.contiguous())
        got = int8_decode_attention(*args)
        again = int8_decode_attention(*args)
        torch.cuda.synchronize()
        want = int8_decode_attention_reference(*args)
        err = (got - want).abs()
        max_err = err.max().item()
        # the kernel's f32 exp and sums may differ from torch's in the
        # last bit, so a requantized p on a .5 tie may round the other
        # way: allow two such units per row, plus f32 noise
        step = p8_step(q, k8, ks, vs, args[-1])
        tol = 2 * step + 1e-5 * want.abs().max()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
        bitwise = torch.equal(got, again)
        units = (err / step).max().item()
        worst = max(worst, max_err)
        ms = timer(lambda: int8_decode_attention(*args))
        warm_ms = timer(lambda: int8_decode_attention(*args), flush=False)
        plain_ms = timer(lambda: int8_decode_attention_reference(*args))
        rows = _read_rows(bias)
        c, stages = decode_attention_plan(b, h, s, sms)
        # the bound: the rows read (k8, v8 and their scales), the bias, q
        # (bf16) and out
        read = sum(rows) * h
        bnd = bound(2 * read * (d + 4) + b * s * 4 + b * h * d * (2 + 4),
                    4 * read * d, H100_INT8_OPS)
        if label == 'served mask':
            result = ((ms, plain_ms), bnd)
        ref_max = want.abs().max().item()
        print(f'int8_decode_attention B={b} H={h} S={s} D={d}, {label}: '
              f'rows read {rows}, C={c}, {b * h * c} CTAs, ring of '
              f'{stages}; max_abs_err {max_err:.3e}, rel '
              f'{max_err / ref_max:.3e} of max|plain| {ref_max:.3e}, '
              f'{units:.3f} p8 units (tol 2 units + 1e-5*max|plain|), two '
              f'calls bitwise equal {bitwise} '
              f'{"ok" if ok and bitwise else "FAIL"}; kernel {ms:.4f} ms '
              f'(L2 flushed), {warm_ms:.4f} ms (not flushed), plain '
              f'{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), '
              f'{100 * bnd[0] / ms:.1f} % of the bound [{card}]')
        if not (ok and bitwise):
            fail(f'int8_decode_attention disagrees with its plain version '
                 f'or with itself, {label} at B={b} S={s}')
    return (worst, *result)


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


def _rate(name, flops, ms, bnd, lib, lib_name, card):
    """A flash kernel's rate, share of its bound and ratio to the PyTorch
    call ``lib_name`` (SDPA), a line each."""
    print(f'  {name} rate: {flops / ms / 1e9:.1f} TFLOP/s [{card}]')
    print(f'  {name} share of bound: {100 * bnd[0] / ms:.1f} % of its '
          f'{bnd[0]:.4f} ms ({bnd[1]}) [{card}]')
    print(f'  {name} against {lib_name}: '
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

    def check_fwd(name, q, k, v, mask, causal, case, dead=False,
                  need_lse=True):
        """The forward against mha_reference in f32 on the same inputs
        (lse within 1e-3; batch row 1 exactly 0 and -1e30 when ``dead``),
        then called again: out and lse bitwise equal (no atomics).  Times
        it with the lse only when ``need_lse`` (as its path calls it).
        Returns (max_abs_err, ms, plain_ms, plain out, plain lse)."""
        d = q.shape[-1]
        got, glse = flash_fwd(q, k, v, mask, causal, d ** -0.5)
        want, wlse = mha_reference(q.float(), k.float(), v.float(), mask,
                                   causal, d ** -0.5)
        err = (got.float() - want).abs()
        ok = bool((err <= _flash_tol(want, fwd_rel)).all())
        ok &= bool(torch.isfinite(got).all())
        ok &= bool((glse - wlse).abs().max() <= 1e-3)
        if dead:
            ok &= bool((got[1] == 0).all()) and bool((glse[1] == -1e30).all())
        again, alse = flash_fwd(q, k, v, mask, causal, d ** -0.5)
        same = torch.equal(got, again) and torch.equal(glse, alse)
        ms = timer(lambda: flash_fwd(q, k, v, mask, causal, d ** -0.5,
                                     need_lse=need_lse))
        plain_ms = timer(lambda: mha_reference(q, k, v, mask, causal,
                                               d ** -0.5))
        b, h, sq, _ = q.shape
        flops = 4 * b * h * sq * k.shape[2] * d / (2 if causal else 1)
        report(name, tuple(q.shape), f'{case}; called twice, out and lse '
               f'bitwise equal {same}', err.max().item(),
               want.abs().max().item(), '2^-7*|plain| + 2^-9*max|plain|, '
               'lse 1e-3' + (', row 1 exactly 0 and -1e30' if dead else ''),
               ok and same, ms, plain_ms, flops)
        return err.max().item(), ms, plain_ms, want, wlse

    # --- #3: the ViT's bidirectional whole-kv forward, (2, 16, 1025, 64),
    # timed without the lse as the ViT calls it
    b, h, s, d = 2, 16, 1025, 64
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    err, ms, plain_ms, want, _ = check_fwd(
        'flash_fwd bidirectional (#3)', q, k, v, mask, False,
        'all keys valid', need_lse=False)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, scale=d ** -0.5)
    lib = library_time(torch, timer, 'F.scaled_dot_product_attention'
                       ' (#3, no mask)', sdpa, want, card)
    print(f'  its kernels: {kernel_names(torch, sdpa)} [{card}]')
    results['bidirectional'] = (
        err, ms, plain_ms,
        bound(4 * b * h * s * d * 2 + b * s, 4 * b * h * s * s * d), lib)
    _rate('flash_fwd bidirectional (#3)', 4 * b * h * s * s * d, ms,
          results['bidirectional'][3], lib, 'SDPA', card)
    m = mask.clone()
    m[0, 700:] = False                        # a masked tail
    m[1] = False                              # every key masked
    check_fwd('flash_fwd bidirectional (#3)', q, k, v, m, False,
              'row 0 tail masked, row 1 all masked', dead=True,
              need_lse=False)
    # the causal instantiation at D = 64 (on no path of the model), under
    # a grounded key mask
    check_fwd('flash_fwd causal, D=64', q, k, v,
              torch.from_numpy(_grounded_key_mask(b, s)).to(dev), True,
              'causal, grounded key mask')
    del want

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
            _rate('flash_bwd bidirectional (#6)', bwd_flops, ms,
                  results['bidirectional backward'][3], lib, 'SDPA backward',
                  card)
        del got, want

    # #6 at Sq != Skv (the cross-attention shape its TPU kernels allow):
    # the ViT's 1025 queries over 1100 keys, then the JAX test's 100 x 130;
    # a grounded key mask with row 1 fully masked, held as above
    for sq, skv in ((s, 1100), (100, 130)):
        q2, k2, v2, do2 = q[:, :, :sq], rand(b, h, skv, d), \
            rand(b, h, skv, d), do[:, :, :sq]
        mask = torch.from_numpy(_grounded_key_mask(b, skv)).to(dev)
        mask[1] = False
        check_fwd('flash_fwd bidirectional (#3)', q2, k2, v2, mask, False,
                  f'Sq={sq} != Skv={skv}, grounded key mask, row 1 all '
                  'masked', dead=True, need_lse=False)
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

    def causal_pair(b, h, tag):
        """#4 and #5 at (b, h, max_seq_len, 128) under a grounded key mask,
        each against its plain version and SDPA -> (#4's and #5's
        result tuples)."""
        cfg = GromaConfig()
        s, d = cfg.max_seq_len, 128
        q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
        mask = torch.from_numpy(grounded_kv_mask(
            grounded_batch(cfg, b, 7), [37, 81])).to(dev)
        case = (f'causal, grounded key mask ('
                + ' and '.join(str(int(m.sum())) for m in mask)
                + f' of {s} valid, region-slot gaps + pad tail){tag}')
        causal_flops = 4 * b * h * s * s * d / 2
        err, ms, plain_ms, want, wlse = check_fwd('flash_fwd causal (#4)', q,
                                                  k, v, mask, True, case)
        # the same function through SDPA: causal and key mask as one
        # boolean mask (SDPA takes one or the other)
        allowed = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[
            None, None] & mask[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=allowed, scale=d ** -0.5)
        lib = library_time(torch, timer, 'F.scaled_dot_product_attention '
                           f'(#4, causal & key mask{tag})', sdpa, want, card)
        print(f'  its kernels: {kernel_names(torch, sdpa)} [{card}]')
        fwd = (err, ms, plain_ms,
               bound(4 * b * h * s * d * 2 + b * s + b * h * s * 4,
                     causal_flops), lib)
        _rate(f'flash_fwd causal (#4){tag}', causal_flops, ms, fwd[3], lib,
              'SDPA', card)
        if not tag:
            # the bidirectional instantiation at D = 128 (on no path of
            # the model)
            check_fwd('flash_fwd bidirectional, D=128', q, k, v, mask, False,
                      'grounded key mask')

        # the backward on one set of inputs: the plain forward's out, lse
        out = want.to(torch.bfloat16)
        lse = wlse
        do = rand(b, h, s, d)
        del want
        dq, dk, dv = flash_bwd(q, k, v, mask, out, lse, do, True, d ** -0.5)
        wq, wk, wv = flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), mask, out.float(), lse,
            do.float(), True, d ** -0.5)
        worst, ref_max, ok = _grad_errors(torch, (dq, dk, dv), (wq, wk, wv),
                                          card)
        _bwd_repeat(torch, f'flash_bwd causal (#5){tag}',
                    lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                      d ** -0.5), (dq, dk, dv),
                    (wq, wk, wv), card)
        # SDPA's autograd backward, from its own forward
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed,
                                                  scale=d ** -0.5)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, do, retain_graph=True)
        lib = library_time(torch, timer, 'F.scaled_dot_product_attention '
                           f'backward (#5{tag})', sdpa_bwd, (wq, wk, wv),
                           card, rel_tol=3e-2)
        print(f'  its kernels: {kernel_names(torch, sdpa_bwd)} [{card}]')
        del dq, dk, dv, wq, wk, wv, sdpa_out, leaves
        ms = timer(lambda: flash_bwd(q, k, v, mask, out, lse, do, True,
                                     d ** -0.5))
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q, k, v, mask, out, lse, do, True, d ** -0.5))
        report('flash_bwd causal (#5)', (b, h, s, d), case, worst, ref_max,
               '2^-6*|plain| + 2^-8*max|plain| per gradient', ok, ms,
               plain_ms, 2.5 * causal_flops)
        bwd = (worst, ms, plain_ms,
               bound(8 * b * h * s * d * 2 + b * h * s * 4 + b * s,
                     2.5 * causal_flops), lib)
        _rate(f'flash_bwd causal (#5){tag}', 2.5 * causal_flops, ms, bwd[3],
              lib, 'SDPA backward', card)
        return fwd, bwd

    # --- #4 and #5: the LLM's causal forward and backward, (2, 32, 2048,
    # 128), and at one tp rank's local heads (phase 13: tp = 2)
    results['causal'], results['backward'] = causal_pair(2, 32, '')
    results['causal_tp'], results['backward_tp'] = causal_pair(
        1, 32 // TP, f', tp={TP} local heads')
    b, h, d = 2, 32, 128

    # #5 at S = 1500, ragged against both the 64-query and 128-key tiles,
    # under a grounded key mask, from the plain forward
    s = 1500
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    mask = torch.from_numpy(_grounded_key_mask(b, s)).to(dev)
    check_fwd('flash_fwd causal (#4)', q, k, v, mask, True,
              'causal, S=1500 (ragged against 128), grounded key mask')
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
    b, s, steps = 2, 200, 4     # prefill M = 400 rows: the prefill tile
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


def _ptxas_summary(log: str, kernel: str) -> str:
    """ptxas's registers, stack and spills of the entry points whose names
    hold ``kernel``, from the build's -v log."""
    found, lines, keep = [], log.splitlines(), False
    for line in lines:
        if 'Compiling entry function' in line:
            keep = kernel in line
            continue
        if keep and ('registers' in line or 'spill' in line):
            found.append(line.split(':', 1)[-1].strip()
                         if 'ptxas' in line else line.strip())
    return '; '.join(found) or 'not in the log (library not rebuilt here)'


def _ptxas_wgmma_warnings(log: str, source: str) -> list:
    """ptxas's lines that say it serialized wgmma products (C7515, C7520)
    in the build of ``source`` (the log's '== <source>' section)."""
    found, keep = [], False
    for line in log.splitlines():
        if line.startswith('== '):
            keep = line[3:].strip() == source
        elif keep and 'wgmma' in line and 'serializ' in line:
            found.append(line.strip())
    return found


def check_int4_matmul(torch, gen, timer, card):
    """#7 against its plain version at every shape of the int4 tree: M=1
    and M=8 (the engine's 8 slots) through the decode tile, M=9, 200 and
    2048 (a prefill) through the prefill tile; both tiles also at a ragged
    N (N % 128 = 64: M=5 and M=200) and with scales that differ strongly
    between blocks (down_proj at M=1, 8 and 2048), and every case called
    twice (bitwise-equal outputs).  Each shape's torch._weight_int4pack_mm
    time beside it, a plain read of the same weight bytes at M <= 8 and, at
    M=2048, torch.matmul in bf16 on a dequantized copy of the weights.
    Returns two tuples, the decode tile's (the four layer matmuls at M=8)
    and the prefill tile's (at M=2048): (max_abs_err over the tile's cases
    with random scales, (kernel ms, plain ms), (bound ms, bound by),
    library ms)."""
    from groma_tpu_torch.ops import cuda_lib
    from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, decode_plan,
                                            dequantize_weight_int4,
                                            int4_matmul,
                                            int4_matmul_reference,
                                            prefill_plan)
    dev = 'cuda'
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = cuda_lib.build_info.get('log', '')
    for tile, kernel in (('decode', 'int4_decode_kernel'),
                         ('prefill', 'int4_prefill_kernel')):
        print(f'int4_matmul {tile} tile, ptxas: '
              f'{_ptxas_summary(log, kernel)} [{card}]')
    serialized = _ptxas_wgmma_warnings(log, 'int4_matmul.cu')
    print(f'int4_matmul prefill tile, ptxas wgmma serialization warnings: '
          f'{"; ".join(serialized) or "none"} [{card}]')
    if serialized:
        fail('ptxas serialized the wgmma products of int4_prefill_kernel')
    worst = {False: 0.0, True: 0.0}      # by m > 8
    # M -> [kernel, plain, bound, library, bound by, plain read, bf16
    # matmul] ms over the four layer matmuls
    sums = {}
    cases = [(m, name, k, n, 'random')
             for m in (1, 8, 9, 200, INT4_PREFILL_ROWS)
             for name, (k, n) in INT4_MATMUL_SHAPES.items()]
    cases += [(5, 'ragged N', 4096, 4160, 'random'),
              (200, 'ragged N', 4096, 4160, 'random'),
              (8, 'ragged N', 512, 192, 'random'),
              (8, 'down_proj', 11008, 4096, 'per-block'),
              (1, 'down_proj', 11008, 4096, 'per-block'),
              (INT4_PREFILL_ROWS, 'down_proj', 11008, 4096, 'per-block')]
    for m, name, k, n, scales in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                               dtype=torch.uint8)
        scale = torch.rand((k // 256, n), generator=gen, device=dev) \
            * 1e-3 + 1e-4
        if scales == 'per-block':
            # 2^0 .. 2^10 from block to block (neighbours far apart): a low
            # nibble paired with the high half's x or scale, or a fold at
            # the wrong block, moves outputs far past the bound
            scale = scale * 2.0 ** ((torch.arange(k // 256, device=dev)
                                     * 7 % 11)[:, None].float())
        got = int4_matmul(x, packed, scale)
        want = int4_matmul_reference(x, packed, scale).float()
        again = int4_matmul(x, packed, scale)
        stable = bool(torch.equal(got, again))
        got = got.float()
        err = (got - want).abs()
        # f32 sums in another order, then one bf16 rounding each: at most
        # one bf16 step (2^-7 relative) apart, plus f32 noise
        tol = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all()) \
            and stable
        max_err = err.max().item()
        if scales == 'random':
            worst[m > 8] = max(worst[m > 8], max_err)
        ms = timer(lambda: int4_matmul(x, packed, scale))
        plain_ms = timer(lambda: int4_matmul_reference(x, packed, scale))
        b_ms, bound_by = bound(k * n // 2 + (k // 256) * n * 4
                               + 2 * m * (k + n), 2 * m * k * n)
        lib = None
        if scales == 'random' and name in INT4_MATMUL_SHAPES \
                and m in (1, 8, INT4_PREFILL_ROWS):
            try:
                fn = _tinygemm(torch, x, packed, scale)
            except (RuntimeError, TypeError, AttributeError) as e:
                print(f'  library torch._weight_int4pack_mm: none (the '
                      f'repacking failed: {type(e).__name__}: '
                      f'{(str(e).splitlines() or [""])[0][:140]}) [{card}]')
                fn = None
            lib = fn and library_time(
                torch, timer, f'torch._weight_int4pack_mm M={m} {name}', fn,
                want, card)
        # the same weight bytes read by one plain PyTorch reduction, under
        # the same timer: what streaming them costs on this card as timed
        read_ms = timer(lambda: packed.view(torch.int32).amax()) \
            if m <= 8 else 0.0
        # a dense bf16 product of the same size (not the same function: a
        # 4x larger weight copy), what such a product costs on this card
        dense_ms = 0.0
        if m == INT4_PREFILL_ROWS and scales == 'random':
            wd = dequantize_weight_int4({'q': packed, 'scale': scale,
                                         'block': INT4_BLOCK},
                                        torch.bfloat16)
            dense_ms = timer(lambda: torch.matmul(x, wd))
            print(f'  torch.matmul bf16 on a dequantized copy M={m} {name}: '
                  f'{dense_ms:.4f} ms ({2 * m * k * n / dense_ms / 1e9:.1f} '
                  f'TFLOP/s) [{card}]')
            del wd
        if scales == 'random' and name in LAYER_MATMULS:
            acc = sums.setdefault(m, [0.0, 0.0, 0.0, 0.0, bound_by, 0.0,
                                      0.0])
            acc[0] += ms
            acc[1] += plain_ms
            acc[2] += b_ms
            acc[3] = None if lib is None or acc[3] is None else acc[3] + lib
            acc[5] += read_ms
            acc[6] += dense_ms
        ref_max = want.abs().max().item()
        if m > 8:
            rate = (f'{2 * m * k * n / ms / 1e9:.1f} TFLOP/s, '
                    f'{100 * b_ms / ms:.1f} % of the bound {b_ms:.4f} ms '
                    f'({bound_by}); plan {prefill_plan(m, n, sms)} (ctas, '
                    f'token tiles, column tiles)')
        else:
            rate = (f'{(k * n / 2 + k * n // 64) / ms / 1e6:.1f} GB/s '
                    f'weights, {100 * b_ms / ms:.1f} % of the bound '
                    f'{b_ms:.4f} ms ({bound_by}), a plain read of the '
                    f'weight bytes (amax) {read_ms:.4f} ms; plan '
                    f'{decode_plan(k, n, sms)} (split rows, splits)')
        print(f'int4_matmul M={m} {name} K={k} N={n}'
              f'{", scales 2^0..2^10 by block" if scales != "random" else ""}'
              f': max_abs_err {max_err:.3e}, rel {max_err / ref_max:.3e} of '
              f'max|plain| {ref_max:.3e} (tol 2^-7*|plain| + '
              f'1e-4*max|plain|) {"ok" if ok else "FAIL"}, two calls '
              f'{"bitwise equal" if stable else "DIFFER"}; kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, {rate} [{card}]')
        if not ok:
            fail(f'int4_matmul disagrees with its plain version at M={m} '
                 f'{name} K={k} N={n} ({scales} scales), or two calls differ')
        if (k // 2) % INT4_BLOCK and scales == 'random':
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
        del x, packed, scale, got, want, err, again
    for m, (ms, plain_ms, b_ms, lib, by, read_ms, dense_ms) in sums.items():
        lib_txt = 'none' if lib is None else f'{lib:.4f} ms'
        ratio = '' if lib is None else f', {ms / lib:.3f} x the library'
        read = f', a plain read of the weights {read_ms:.4f} ms' \
            if read_ms else ''
        dense = (f', torch.matmul bf16 on dequantized copies {dense_ms:.4f} '
                 f'ms ({ms / dense_ms:.3f} x)' if dense_ms else '')
        print(f'int4_matmul M={m}, the four layer matmuls: kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), '
              f'{100 * b_ms / ms:.1f} % of the bound, '
              f'torch._weight_int4pack_mm {lib_txt}{ratio}{read}{dense} '
              f'[{card}]')

    def result(m):
        ms, plain_ms, b_ms, lib, by = sums[m][:5]
        return worst[m > 8], [ms, plain_ms], (b_ms, by), lib
    return result(8), result(INT4_PREFILL_ROWS)


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


def _paged_case(torch, gen, dev, lengths, np_: int):
    """The engine's paged shapes: shuffled pages, repeat-last table tails,
    a frozen row (length 0) on the trash page, ``np_``-page table rows."""
    from groma_tpu_torch.models.llama_quant import _quantize_tokens
    from groma_tpu_torch.ops.paged_attention import PAGE
    h, d = 32, 128
    b = len(lengths)
    k8, ks = _quantize_tokens(torch.randn(
        (PAGED_POOL_PAGES, h, PAGE, d), generator=gen, device=dev))
    v8, vs = _quantize_tokens(torch.randn(
        (PAGED_POOL_PAGES, h, PAGE, d), generator=gen, device=dev))
    ids = (torch.randperm(PAGED_POOL_PAGES - 1, generator=gen, device=dev)
           + 1).tolist()
    table = torch.zeros((b, np_), dtype=torch.int32)
    for row, n in enumerate(lengths):
        used = -(-n // PAGE)
        if used:
            table[row, :used] = torch.tensor(ids[:used])
            table[row, used:] = ids[used - 1]
            ids = ids[used:]
    q = torch.randn((b, h, 1, d), generator=gen, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, k8, ks, v8, vs, table.to(dev), lengths)


def check_paged_attention(torch, gen, timer, card):
    """#8 against its plain version at chip_smoke's engine shapes
    (PAGED_LENGTHS, with a frozen row) and at the engine's own lengths
    (ENGINE_PAGED_LENGTHS over 19-page tables), each called twice, bitwise
    equal.  Returns (max_abs_err, kernel ms, plain ms, (bound ms, bound
    by)) at PAGED_LENGTHS; no PyTorch call computes it."""
    from groma_tpu_torch.ops.paged_attention import (
        PAGE, paged_int8_decode_attention, paged_int8_decode_attention_plain,
        paged_plan)
    _kernel_ptxas(card, 'paged_attention_kernel')
    worst, result = 0.0, None
    for label, lengths, np_ in (
            ('chip_smoke', PAGED_LENGTHS, -(-max(PAGED_LENGTHS) // PAGE)),
            ("the engine's", ENGINE_PAGED_LENGTHS, ENGINE_TABLE_PAGES)):
        args = _paged_case(torch, gen, 'cuda', lengths, np_)
        got = paged_int8_decode_attention(*args)
        again = paged_int8_decode_attention(*args)
        torch.cuda.synchronize()
        want, step = paged_int8_decode_attention_plain(*args,
                                                       with_step=True)
        err = (got - want).abs()
        # the kernel's f32 exp and sums may differ from torch's in the
        # last bit, so a requantized p on a .5 tie may round the other
        # way: allow two such units of any page, plus f32 noise
        tol = 2 * step + 1e-5 * want.abs().max()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
        if 0 in lengths:                        # uniform p, not 0
            ok &= bool(got[lengths.index(0)].abs().max() > 0)
        bitwise = torch.equal(got, again)
        max_err = err.max().item()
        worst = max(worst, max_err)
        units = (err / step).max().item()
        ms = timer(lambda: paged_int8_decode_attention(*args))
        warm_ms = timer(lambda: paged_int8_decode_attention(*args),
                        flush=False)
        plain_ms = timer(lambda: paged_int8_decode_attention_plain(*args))
        b, h, d = len(lengths), args[0].shape[1], args[0].shape[3]
        pages = [-(-n // PAGE) if n else np_ for n in lengths]
        c = paged_plan(b, h, np_, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
        kv_bytes = sum(pages) * h * 2 * PAGE * (d + 4)
        bnd = bound(kv_bytes + 2 * b * h * d * 4 + args[5].numel() * 4
                    + b * 4, 4 * sum(lengths) * h * d, H100_INT8_OPS)
        if label == 'chip_smoke':
            result = (ms, plain_ms, bnd)
        ref_max = want.abs().max().item()
        print(f'paged_int8_decode_attention B={b} H={h} D={d}, {label} '
              f'lengths {lengths} over {np_}-page tables and a '
              f'{PAGED_POOL_PAGES}-page pool: pages read {pages}, C={c}, '
              f'{b * h * c} CTAs; max_abs_err {max_err:.3e}, rel '
              f'{max_err / ref_max:.3e} of max|plain| {ref_max:.3e}, '
              f'{units:.3f} p8 units (tol 2 units + 1e-5*max|plain|), '
              f'{"frozen row finite and uniform, " if 0 in lengths else ""}'
              f'two calls bitwise equal {bitwise} '
              f'{"ok" if ok and bitwise else "FAIL"}; kernel '
              f'{ms:.4f} ms (L2 flushed), {warm_ms:.4f} ms (not flushed), '
              f'plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), '
              f'{100 * bnd[0] / ms:.1f} % of the bound, '
              f'{kv_bytes / ms / 1e6:.1f} GB/s KV [{card}]')
        if not (ok and bitwise):
            fail(f'paged_int8_decode_attention disagrees with its plain '
                 f'version or with itself at {label} lengths')
    return (worst, *result)


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
                                  else v.clone() if torch.is_tensor(v)
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


def _bitwise_repeat(torch, mk, sp, x, inputs, pos: int, eps, got, mine,
                    again) -> bool:
    """A second call of #9 on ``again``, a copy of the cache ``mine``
    started from: the same hidden state and cache, bit for bit."""
    out = mk.fused_decode_step(sp, x, again, *inputs, pos, eps=eps)
    return torch.equal(out, got) and all(
        torch.equal(a, b) for key in ('k', 'v', 'k_scale', 'v_scale')
        for a, b in zip(mine[key], again[key]))


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
    d, dev = cfg.hidden_size, 'cuda'
    cache = _megakernel_cache(torch, gen, cfg, b, s, pos)
    lengths = torch.tensor([pos - 37 * r for r in range(b)], device=dev)
    valid = torch.arange(s, device=dev)[None] < lengths[:, None]
    valid[1, 100:160] = False
    valid[b - 1] = False
    cache['mask'], cache['index'] = valid, pos
    cur_valid = torch.ones((b, 1), dtype=torch.bool, device=dev)
    cur_valid[b - 1] = False
    mine, again, theirs = (_stacked_clone(torch, mk, cache)
                           for _ in range(3))
    x = torch.randn((b, d), generator=gen, device=dev)
    inputs = megakernel_step_inputs(cfg, cache, cur_valid)
    eps = cfg.rms_norm_eps
    from groma_tpu_torch.ops import cuda_lib
    ptxas = _ptxas_summary(cuda_lib.build_info.get('log', ''),
                           'decode_megakernel')
    print(f'decode_megakernel (#9) ptxas: {ptxas} [{card}]')
    if 'spill' in ptxas and not all(
            f' 0 bytes spill {kind}' in f' {ptxas}'
            for kind in ('stores', 'loads')):
        fail('ptxas spilled registers of decode_megakernel')
    with torch.no_grad():
        got = mk.fused_decode_step(sp, x, mine, *inputs, pos, eps=eps)
        want = mk.fused_decode_step_plain(sp, x, theirs, *inputs, pos,
                                          eps=eps)
        torch.cuda.synchronize()
        cmp = _compare_step(torch, got, want, cache, mine, theirs, pos)
        ok = _step_ok(cmp, MEGAKERNEL_HIDDEN_TOL)
        stable = _bitwise_repeat(torch, mk, sp, x, inputs, pos, eps, got,
                                 mine, again)
        ok &= stable
        reads = [s if not bool(cur_valid[r]) else pos for r in range(b)]
        bound_ms, bound_by = bound(*_megakernel_traffic(
            cfg, cfg.num_layers, b, s, reads))
        ms = timer(lambda: mk.fused_decode_step(sp, x, mine, *inputs, pos,
                                                eps=eps))
        plain_ms = timer(lambda: mk.fused_decode_step_plain(
            sp, x, theirs, *inputs, pos, eps=eps), iters=3)
    print(f'decode_megakernel (#9) full width, {cfg.num_layers} layers, '
          f'B={b} S={s} pos={pos}, ragged mask, row {b - 1} fully masked: '
          f'{_step_line(cmp, MEGAKERNEL_HIDDEN_TOL)}; two calls on copies '
          f'of the cache {"bitwise equal" if stable else "DIFFER"}; kernel '
          f'{ms:.4f} ms ({mk.fused_decode_step.blocks} blocks, '
          f'{mk.fused_decode_step.smem} bytes of dynamic shared memory, '
          f'{mk.fused_decode_step.barriers} grid barriers), plain '
          f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]')
    if not ok:
        fail('decode_megakernel disagrees with its plain version, or two '
             'calls differ')
    del sp, cache, mine, again, theirs
    check_megakernel_two_pairs(torch, gen, mk, cfg, qp, card)
    del qp


def _megakernel_cache(torch, gen, cfg, b: int, s: int, pos: int):
    """A random int8 cache of ``cfg``'s layers written up to ``pos``."""
    cache = {'k': [], 'v': [], 'k_scale': [], 'v_scale': []}
    for _ in range(cfg.num_layers):
        for key in ('k', 'v'):
            t = torch.randint(-127, 128, (b, cfg.num_heads, s, 128),
                              generator=gen, device='cuda', dtype=torch.int8)
            t[:, :, pos:] = 0
            cache[key].append(t)
            sc = torch.rand((b, cfg.num_heads, s), generator=gen,
                            device='cuda') * 0.02 + 0.005
            sc[:, :, pos:] = 0
            cache[key + '_scale'].append(sc)
    return cache


# (a'): grids of fewer CTAs than the card's 132 SMs, so that a CTA runs two
# attention pairs, at a short slot beside a fully masked row (2 ring stages
# an item against 32): the two consumer groups' skew between pairs
MEGAKERNEL_SKEW_POS, MEGAKERNEL_SKEW_ROW = 64, 3
MEGAKERNEL_SKEW_CTAS = (114, 78)


def check_megakernel_two_pairs(torch, gen, mk, cfg, qp, card: str):
    """(a') #9 on plans of MEGAKERNEL_SKEW_CTAS CTAs at full width and 2
    layers, B=8, slot MEGAKERNEL_SKEW_POS, row MEGAKERNEL_SKEW_ROW fully
    masked, against its plain version with (a)'s limits, two calls bitwise
    equal; and a mask that does not start at a 16-byte aligned address is
    refused."""
    from groma_tpu_torch.models.llama_quant import megakernel_step_inputs
    b, s, pos = DECODE_BATCH, DECODE_SLOTS, MEGAKERNEL_SKEW_POS
    cache = _megakernel_cache(torch, gen, cfg, b, s, pos)
    valid = torch.arange(s, device='cuda')[None].expand(b, s) < pos
    valid = valid.clone()
    valid[MEGAKERNEL_SKEW_ROW] = False
    cache['mask'], cache['index'] = valid, pos
    cur_valid = torch.ones((b, 1), dtype=torch.bool, device='cuda')
    cur_valid[MEGAKERNEL_SKEW_ROW] = False
    inputs = megakernel_step_inputs(cfg, cache, cur_valid)
    x = torch.randn((b, cfg.hidden_size), generator=gen, device='cuda')
    eps, ok = cfg.rms_norm_eps, True
    with torch.no_grad():
        for ctas in MEGAKERNEL_SKEW_CTAS:
            sp = mk.stack_decode_params(qp, ctas=ctas)
            mine, again, theirs = (_stacked_clone(torch, mk, cache)
                                   for _ in range(3))
            got = mk.fused_decode_step(sp, x, mine, *inputs, pos, eps=eps)
            blocks = mk.fused_decode_step.blocks
            want = mk.fused_decode_step_plain(sp, x, theirs, *inputs, pos,
                                              eps=eps)
            cmp = _compare_step(torch, got, want, cache, mine, theirs, pos)
            stable = _bitwise_repeat(torch, mk, sp, x, inputs, pos, eps, got,
                                     mine, again)
            good = _step_ok(cmp, MEGAKERNEL_HIDDEN_TOL) and stable \
                and blocks == ctas
            ok &= good
            print(f'decode_megakernel (#9) on {blocks} CTAs (two attention '
                  f'pairs a CTA), full width, {cfg.num_layers} layers, B={b} '
                  f'S={s} pos={pos}, row {MEGAKERNEL_SKEW_ROW} fully masked: '
                  f'{_step_line(cmp, MEGAKERNEL_HIDDEN_TOL)}; two calls on '
                  f'copies of the cache '
                  f'{"bitwise equal" if stable else "DIFFER"} [{card}]')
            del sp, mine, again, theirs
        # a call on a second stream gets workspace words of its own and
        # the same result, bit for bit
        sp = mk.stack_decode_params(qp)
        kv0, kv1 = (_stacked_clone(torch, mk, cache) for _ in range(2))
        got = mk.fused_decode_step(sp, x, kv0, *inputs, pos, eps=eps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = mk.fused_decode_step(sp, x, kv1, *inputs, pos, eps=eps)
            own = any(k[1] == side.cuda_stream for k in mk._workspaces)
        torch.cuda.current_stream().wait_stream(side)
        same = torch.equal(got, other) and all(
            torch.equal(u, v) for k in ('k', 'v', 'k_scale', 'v_scale')
            for u, v in zip(kv0[k], kv1[k]))
        ok &= own and same
        print(f'decode_megakernel (#9) on a second stream: workspace of its '
              f'own {own}, bitwise equal to the first stream\'s '
              f'{same} [{card}]')
        del kv0, kv1
        shifted = torch.zeros(b * s + 1, device='cuda')[1:].view(b, s)
        shifted.copy_(inputs[0])
        try:
            mk.fused_decode_step(sp, x, _stacked_clone(torch, mk, cache),
                                 shifted, *inputs[1:], pos, eps=eps)
            refused = False
        except ValueError as e:
            refused = 'aligned' in str(e)
        ok &= refused
        print(f'decode_megakernel (#9): a mask 4 bytes past a 16-byte '
              f'boundary {"refused" if refused else "NOT refused"} [{card}]')
    if not ok:
        fail('decode_megakernel on a grid of two attention pairs a CTA '
             'disagrees with its plain version, or a misaligned mask was '
             'taken')


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


# the kernels a decode step launches, by wrapper counter: the symbols a
# profiled replay shows for them
COUNTER_KERNELS = {
    'int8_matmul': ('int8_decode_kernel', 'int8_prefill_kernel'),
    'int8_matmul.prefill': ('int8_prefill_kernel',),
    'int4_matmul': ('int4_decode_kernel', 'int4_prefill_kernel'),
    'int4_matmul.prefill': ('int4_prefill_kernel',),
    'int8_decode_attention': ('int8_decode_attention_kernel',),
    'paged_int8_decode_attention': ('paged_attention_kernel',),
    'decode_megakernel': ('decode_megakernel',),
}
TWIN_PROFILED = 2          # steps of each mode under torch.profiler


def zero_counts():
    """Every wrapper's counter and the graphs' tallies (the prefill
    graphs' warm-ups too) to 0."""
    from groma_tpu_torch.utils.graphs import StepGraph, launch_counts
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
    StepGraph.reset_tally()


def device_launches() -> dict:
    """Launches that ran on the device since ``zero_counts``: the
    wrappers' counts, without the calls made while a step or a prefill was
    captured and with every replay's (a prefill graph's warm-up ran)."""
    from groma_tpu_torch.utils.graphs import StepGraph, launch_counts
    return StepGraph.device_launches(launch_counts())


def warmups() -> int:
    """Prefill graphs warmed up (one a capture) since ``zero_counts``."""
    from groma_tpu_torch.utils.graphs import CallGraph
    return CallGraph.warmups


def _clone_tree(torch, tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(torch, v) for v in tree)
    return tree


def _profiled(torch, fn, steps: int):
    """``fn()`` (``steps`` decode steps) under torch.profiler -> (device ms
    a step, {kernel name: launches a step})."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type.name == 'CUDA' and e.device_time > 0]
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    return (sum(e.device_time for e in events) / 1e3 / steps,
            {k: v / steps for k, v in names.items()})


def _timed(torch, fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / max(steps, 1)


class GraphTwin:
    """While armed, the next StepGraph.run of at least ``min_steps`` steps
    on the card is checked against the eager step: the step runs eagerly
    on a copy of the state (``clone``; the launch counters are put back
    after it: these are comparison launches), then the graph's own run
    goes in parts, its warm-up step and capture apart from its replays,
    TWIN_PROFILED of each mode under torch.profiler.  ``result``: ms a
    step, device ms a step and busy share of each mode, the eager and
    replayed tokens (state key ``tokens``) bitwise equal, the per-replay
    launch counts (the capture's counter moves) and the launches of each
    kernel that the profiled replays show a replay."""

    def __init__(self, torch):
        from groma_tpu_torch.utils import graphs
        self.torch, self.graphs = torch, graphs
        self.orig = graphs.StepGraph.run
        self.armed = None
        self.result = None

    def arm(self, tokens: str, clone=None, min_steps: int = 6):
        self.armed = (tokens, clone, min_steps)
        self.result = None
        twin = self

        def run(graph, n):
            if twin.armed is None or n < twin.armed[2] \
                    or graph.device.type != 'cuda':
                return twin.orig(graph, n)
            key, clone_fn, _ = twin.armed
            twin.armed = None
            twin.result = twin._check(graph, n, key, clone_fn)
        self.graphs.StepGraph.run = run

    def disarm(self):
        self.graphs.StepGraph.run = self.orig
        self.armed = None

    def _check(self, graph, n, key, clone_fn):
        torch, orig = self.torch, self.orig
        counts = self.graphs.launch_counts()
        copy = (clone_fn or (lambda st: _clone_tree(torch, st)))(graph.state)

        def eager(k):
            def go():
                for _ in range(k):
                    graph.step(copy)
            return go
        p = TWIN_PROFILED
        eager_dev, _ = _profiled(torch, eager(p), p)
        eager_ms = _timed(torch, eager(n - p), n - p)
        set_launch_counts(counts)
        done, capture_ms = 0, None
        if graph.graph is None:
            orig(graph, 1)                 # the warm-up step
            t0 = time.perf_counter()
            orig(graph, 1)                 # the capture, one replay
            torch.cuda.synchronize()
            capture_ms = (time.perf_counter() - t0) * 1e3
            done = 2
        graph_dev, names = _profiled(torch, lambda: orig(graph, p), p)
        rest = n - done - p
        graph_ms = _timed(torch, lambda: orig(graph, rest), rest)
        equal = torch.equal(copy[key], graph.state[key])
        seen = {c: sum(v for k, v in names.items()
                       if any(sym in k for sym in COUNTER_KERNELS[c]))
                for c in graph.delta}
        return {'steps': n, 'eager_ms': eager_ms, 'graph_ms': graph_ms,
                'eager_dev': eager_dev, 'graph_dev': graph_dev,
                'capture_ms': capture_ms, 'equal': equal,
                'delta': dict(graph.delta), 'seen': seen}

    def line(self, name: str, card: str) -> str:
        """The result as a printed line; fails the phase if the run never
        came, the tokens differ or a replay's kernels disagree with its
        launch counts."""
        r = self.result
        if r is None:
            fail(f'{name}: no decode loop of at least the checked length ran '
                 f'through a StepGraph on the card')
        if not r['equal']:
            fail(f'{name}: the replayed tokens differ from the eager step\'s '
                 f'on a copy of the same state')
        if any(abs(r['seen'][c] - d) > 1e-9 for c, d in r['delta'].items()):
            fail(f'{name}: a profiled replay launched {r["seen"]} (by the '
                 f'kernels\' names), the capture counted {r["delta"]}')
        return (f'{name}, {r["steps"]} steps of one run, graph against eager '
                f'(the same step on a copy of the state): tokens bitwise '
                f'equal; {r["graph_ms"]:.3f} against {r["eager_ms"]:.3f} ms '
                f'a step (host clock, synchronized), device time '
                f'{r["graph_dev"]:.3f} against {r["eager_dev"]:.3f} ms a step '
                f'(torch.profiler, {TWIN_PROFILED} steps each), device busy '
                f'{100 * r["graph_dev"] / r["graph_ms"]:.1f} % against '
                f'{100 * r["eager_dev"] / r["eager_ms"]:.1f} %; '
                + (f'after the warm-up step, capture and first replay '
                   f'{r["capture_ms"]:.1f} ms; ' if r['capture_ms'] else
                   'the graph captured earlier; ')
                + f'a replay launches {r["delta"]} (its profiled kernels '
                f'agree) [{card}]')


# the prefill graphs (utils.graphs.CallGraph): the kernels whose launches
# a replayed prefill is held to, and the limit of the replay's outputs and
# cache against the eager twin's, relative to max|eager|: bitwise, as no
# kernel of a prefill adds in a varying order (#1's split-K head sums its
# splits in one CTA's fixed order; the flash kernels and the int4 and int8
# prefill tiles split nothing)
PREFILL_KERNELS = ('int8_matmul.prefill', 'flash_fwd.bidirectional',
                   'flash_fwd.causal', 'int4_matmul.prefill')
PREFILL_TWIN_TOL = 0.0
PREFILL_REPLAYS = 3        # replays timed on the host clock
WARM_NOTE = '; its warm-up, capture and the twin included'


def flip_images(inputs):
    """A prefill's inputs with its images mirrored left to right: the
    control, which the twin's limit must refuse."""
    return (inputs[0].flip(2),) + tuple(inputs[1:])


def _rel_diff(torch, got, want) -> float:
    """max|got - want| / max|want| (0.0 when bitwise equal)."""
    if torch.equal(got, want):
        return 0.0
    g, w = got.double(), want.double()
    return ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()


def _prefill_key(key) -> str:
    flags, _, sig = key
    shapes = ', '.join('x'.join(map(str, t[0])) for t in sig if t)
    return f'{"/".join(map(str, flags))} ({shapes})'


class PrefillTwin:
    """While armed, the next prefill graph run on the card of each body
    named in ``controls`` is checked right after its replay, before its
    owner reads the outputs: the key's graph replayed PREFILL_REPLAYS times
    on the host clock and once under torch.profiler (device ms, and the
    device operations a replay runs: its graph's nodes), then the body run
    eagerly on the same static inputs and a copy of its state (the eager
    twin; host and device ms; its launches, comparison launches, taken back
    off the counters).  Every output and state tensor (the KV cache)
    against the replay's within PREFILL_TWIN_TOL x max|eager|, the control
    (the body fed ``controls[name](inputs)``) beyond it, and the replay's
    launches equal to the eager body's."""

    def __init__(self, torch):
        from groma_tpu_torch.utils import graphs
        self.torch, self.graphs = torch, graphs
        self.orig = graphs.CallGraph.run
        self.results = {}

    def arm(self, controls: dict):
        self.results = {}
        pending = dict(controls)
        twin = self

        def run(cg, fn, state, *inputs, key=()):
            out = twin.orig(cg, fn, state, *inputs, key=key)
            name = getattr(fn, '__name__', '')
            if name in pending and cg.mode == 'captured':
                twin.results[name] = twin._check(cg, fn, state, inputs, key,
                                                 out, pending.pop(name))
            return out
        self.graphs.CallGraph.run = run

    def disarm(self):
        self.graphs.CallGraph.run = self.orig

    def _check(self, cg, fn, state, inputs, key, out, control):
        torch, graphs = self.torch, self.graphs
        full = (key, id(state), graphs._signature(inputs))
        entry = cg.entries[full]
        counts = graphs.launch_counts()
        n = PREFILL_REPLAYS

        def replays():
            for _ in range(n):
                entry.graph.replay()
        replay_ms = _timed(torch, replays, n)
        replay_dev, names = _profiled(torch, replays, n)
        copy = _clone_tree(torch, entry.state)
        eager = []
        eager_ms = _timed(torch, lambda: eager.append(
            fn(copy, *entry.inputs)), 1)
        moved = {k: v - counts[k] for k, v in graphs.launch_counts().items()
                 if v != counts[k]}
        eager_dev, _ = _profiled(torch, lambda: fn(
            _clone_tree(torch, entry.state), *entry.inputs), 1)
        pairs = list(zip(graphs._tensors(out), graphs._tensors(eager[0])))
        pairs += list(zip(graphs._tensors(entry.state),
                          graphs._tensors(copy)))
        worst = max(_rel_diff(torch, a, b) for a, b in pairs)
        ctrl = fn(_clone_tree(torch, entry.state), *control(entry.inputs))
        ctrl_diff = _rel_diff(torch, next(graphs._tensors(ctrl)),
                              next(graphs._tensors(out)))
        set_launch_counts(counts)               # comparison launches
        return {'key': _prefill_key(full), 'replay_ms': replay_ms,
                'replay_dev': replay_dev, 'nodes': sum(names.values()),
                'eager_ms': eager_ms, 'eager_dev': eager_dev,
                'capture_ms': entry.capture_ms,
                'pools': [(_prefill_key(k), e.pool_bytes / 2**30)
                          for k, e in cg.entries.items()],
                'worst': worst, 'control': ctrl_diff,
                'delta': dict(entry.delta), 'eager': moved,
                'tensors': len(pairs)}

    def line(self, name: str, body: str, card: str) -> str:
        """The check of ``body`` as a printed line; fails the phase if it
        never ran, or a limit is missed."""
        r = self.results.get(body)
        if r is None:
            fail(f'{name}: no prefill graph of {body} was replayed on the '
                 f'card')
        per = {k: r['delta'].get(k, 0) for k in PREFILL_KERNELS}
        ran = device_launches()
        problems = []
        if r['worst'] > PREFILL_TWIN_TOL:
            problems.append(f'the replay parts from the eager twin by '
                            f'{r["worst"]:.3e} x max|eager|')
        if not r['control'] > PREFILL_TWIN_TOL:
            problems.append(f'the control reads {r["control"]:.3e}, within '
                            f'the limit')
        if r['eager'] != r['delta']:
            problems.append(f'a replay launches {r["delta"]}, the eager '
                            f'prefill {r["eager"]}')
        if problems:
            fail(f'{name}, prefill graph ({body}): ' + '; '.join(problems))
        pools = ', '.join(f'{k} {g:.3f} GiB' for k, g in r['pools'])
        return (f'{name}, prefill graph ({body}, key {r["key"]}): replay '
                f'{r["replay_ms"]:.2f} ms (host clock, synchronized, mean of '
                f'{PREFILL_REPLAYS}), {r["replay_dev"]:.2f} ms of device time '
                f'and {r["nodes"]:.0f} device operations a replay '
                f'(torch.profiler, {PREFILL_REPLAYS} replays)'
                f'; the eager twin {r["eager_ms"]:.2f} ms, '
                f'{r["eager_dev"]:.2f} ms of device time; capture '
                f'{r["capture_ms"]:.1f} ms; pool by key: {pools}; '
                f'{r["tensors"]} outputs and cache tensors '
                + ('bitwise equal to the eager twin\'s' if not r['worst']
                   else f'within {r["worst"]:.3e} x max|eager|')
                + f' (limit {PREFILL_TWIN_TOL}; the control, fed another '
                f'input, reads {r["control"]:.3e}); launches a replay '
                f'{per} (#1 prefill tile, #3, #4, #7 prefill tile; all '
                f'{r["delta"]}, the eager prefill\'s exactly), over the path '
                f'so far { {k: ran[k] for k in PREFILL_KERNELS} } [{card}]')


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
    from groma_tpu_torch.models.llama import torch_dtype
    from groma_tpu_torch.ops import decode_megakernel as mk
    from groma_tpu_torch.ops.quant4 import int4_matmul
    from groma_tpu_torch.utils import graphs
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
        int4_matmul.launches = int4_matmul.prefill_launches = 0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        h, cache = quant_llama_forward(
            qp, cfg, qp['embed_tokens'][ids],
            torch.ones((b, pre), dtype=torch.bool, device=dev),
            torch.arange(pre, device=dev)[None].expand(b, pre), cache)
        tok = quant_llama_logits(qp, h[:, -1:])[:, 0].argmax(-1)
        e1.record()
        torch.cuda.synchronize()
        prefill_counts = (int4_matmul.launches, int4_matmul.prefill_launches)
        print(f'decode path: the {b} x {pre}-token prefill (the LLM at M = '
              f'{b * pre}) and its logits: {e0.elapsed_time(e1):.1f} ms '
              f'(CUDA events, the first call); launches int4_matmul '
              f'{prefill_counts[0]}, of them the prefill tile '
              f'{prefill_counts[1]} (want {(4 * n_layers + 1, 4 * n_layers)}) '
              f'[{card}]')
        if prefill_counts != (4 * n_layers + 1, 4 * n_layers):
            fail('decode path: the prefill did not run its layer matmuls '
                 'through the int4 prefill tile')
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
            n = device_launches()
            return (n['decode_megakernel'], n['int4_matmul'],
                    n['int8_decode_attention'])

        # the megakernel path, greedy, as one captured step replayed (the
        # main path's counts): the token fed at step i and its hidden
        # state written at the device step counter; the cache slot is
        # stack_kv_cache's device word, checked here once for the run
        if pre + steps > slots:
            fail(f'decode path: {steps} steps after {pre} tokens overflow '
                 f'the {slots}-slot cache')
        state = {'kv': st, 'tok': tok.clone(),
                 'toks': torch.zeros((steps, b), dtype=torch.int64,
                                     device=dev),
                 'hidden': torch.zeros((steps, b, cfg.hidden_size),
                                       dtype=torch_dtype(cfg.dtype),
                                       device=dev),
                 'step': torch.zeros((), dtype=torch.int64, device=dev)}

        def mk_step(s):
            at = s['step'].view(1)
            s['toks'].index_copy_(0, at, s['tok'][None])
            hm, _ = quant_llama_decode_megakernel(
                qp, sp, cfg, qp['embed_tokens'][s['tok']][:, None], one,
                s['kv'])
            s['hidden'].index_copy_(0, at, hm[:, 0][None])
            s['tok'].copy_(quant_llama_logits(qp, hm)[:, -1].argmax(-1))
            s['step'].add_(1)

        def mk_clone(s):
            return {**_clone_tree(torch, {k: v for k, v in s.items()
                                          if k != 'kv'}),
                    'kv': _stacked_clone(torch, mk, s['kv'])}
        zero_counts()
        twin = GraphTwin(torch)
        twin.arm('toks', clone=mk_clone, min_steps=steps)
        try:
            graphs.StepGraph(mk_step, state).run(steps)
        finally:
            twin.disarm()
        mk_counts = counts()
        twin_line = twin.line('decode path, megakernel', card)
        r = twin.result
        per_step = r['delta']
        toks = list(state['toks'])
        hidden = list(state['hidden'])
        tok = state['tok']
        # the per-layer path on the same tokens
        zero_counts()
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
        want_step = {'decode_megakernel': 1, 'int4_matmul': 1}
        finite = all(bool(torch.isfinite(x).all()) for x in hidden)
        in_vocab = all(bool(((t >= 0) & (t < cfg.vocab_size)).all())
                       for t in toks)
        ok = (mk_counts == want_mk and per_step == want_step
              and pl_counts == want_pl and finite
              and in_vocab and worst <= MEGAKERNEL_PATH_TOL
              and int(st['index']) == per_layer['index'] == pre + steps)
        pl_warm = sorted(pl_wall[1:])
        mk_ms = r['graph_ms']
        pl_ms = pl_warm[len(pl_warm) // 2] * 1e3
        avg_reads = pre + (steps - 1) / 2
        avg_bound = bound(*_megakernel_traffic(cfg, n_layers, b, slots,
                                               [avg_reads] * b))
        print(f'decode path, megakernel: {steps} greedy steps at B={b} '
              f'through one captured step: {mk_ms:.2f} ms/step over the '
              f'{steps - 2 - TWIN_PROFILED} timed replays '
              f'({b / mk_ms * 1e3:.1f} '
              f'tok/s), device time {r["graph_dev"]:.3f} ms/step '
              f'(torch.profiler), bound {avg_bound[0]:.3f} ms/step at the '
              f'mean slot ({avg_bound[1]}); launches megakernel '
              f'{mk_counts[0]}, int4_matmul {mk_counts[1]} (the lm head), '
              f'decode attention {mk_counts[2]} (want {want_mk}), a replay '
              f'{per_step} (want {want_step}) [{card}]')
        print(twin_line)
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

        # device time and operations a step of the per-layer path (the
        # megakernel path's are the captured step's, above)
        def pl_step():
            nonlocal per_layer
            _, per_layer = quant_llama_forward(
                qp, cfg, qp['embed_tokens'][tok][:, None], one,
                torch.full((b, 1), per_layer['index'], device=dev),
                per_layer)
        device = {'megakernel': r['graph_dev']}
        ms_dev, ops, wall_ms = device_per_step(torch, pl_step)
        device['per-layer'] = ms_dev
        print(f'decode path, per-layer, {PROFILED_STEPS} steps under '
              f'torch.profiler: {ms_dev:.3f} ms of device time and '
              f'{ops:.0f} device operations a step, {wall_ms:.2f} ms '
              f'wall a step (profiler cost included): device busy '
              f'{100 * ms_dev / wall_ms:.1f} % [{card}]')

        # the kernel alone at the path's last slot against its plain
        # version, on copies of the path's cache: the path's 32-layer
        # launch, then each layer alone on the plain version's input to it
        index = int(st['index'])
        x = qp['embed_tokens'][tok].float()
        inputs = megakernel_step_inputs(cfg, st, one)
        eps = cfg.rms_norm_eps
        mine, again, theirs = (_stacked_clone(torch, mk, st)
                               for _ in range(3))
        got = mk.fused_decode_step(sp, x, mine, *inputs, index, eps=eps)
        want = mk.fused_decode_step_plain(sp, x, theirs, *inputs, index,
                                          eps=eps)
        cmp = _compare_step(torch, got, want, st, mine, theirs, index)
        stable = _bitwise_repeat(torch, mk, sp, x, inputs, index, eps, got,
                                 mine, again)
        del again
        ok = _step_ok(cmp, MEGAKERNEL_DEPTH_TOL, column=False) and stable
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
        ok &= ms < device['per-layer']
        print(f'decode_megakernel (#9) alone, {n_layers} layers, B={b}, slot '
              f'{index} of {slots}: '
              f'{_step_line(cmp, MEGAKERNEL_DEPTH_TOL, column=False)}; '
              f'two calls on copies of the cache '
              f'{"bitwise equal" if stable else "DIFFER"}; '
              f'kernel {ms:.3f} ms ({mk.fused_decode_step.blocks} blocks), '
              f'plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms '
              f'({bound_by}), {100 * bound_ms / ms:.1f} % of the bound; the '
              f'per-layer path takes {device["per-layer"]:.3f} ms of device '
              f'time a step [{card}]')
        print(f'  the plain step against itself with its input moved by 1e-6 '
              f'relative: hidden rel {drift["rel"]:.3e} of max|plain|, '
              f'{drift["off"]} of {drift["bytes"]} written int8 bytes '
              f'changed [{card}]')
        print(f'  each of the {n_layers} layers alone (one launch, one '
              f'layer\'s weights and cache) on the plain version\'s input to '
              f'it: worst layer {worst}: '
              f'{_step_line(each, MEGAKERNEL_HIDDEN_TOL)} [{card}]')
        megakernel_phase_split(torch, mk, sp, x, st, inputs, index, eps,
                               n_layers, card)
        if not ok:
            fail(f'decode_megakernel disagrees with its plain version at '
                 f'{n_layers} layers, two calls differ, or it is not faster '
                 f'than the per-layer path')
    del qp, sp, st, cache, per_layer, hidden, mine, theirs, state
    return mk_counts[0], (cmp['err'], ms, plain_ms, bound_ms, bound_by)


def megakernel_phase_split(torch, mk, sp, x, st, inputs, pos: int, eps,
                           n_layers: int, card: str):
    """One launch of #9 with its phase stamps, on a copy of the cache: how
    its time splits among the matmul phases, attention, the idle tails of
    uneven rounds and the grid barriers (``mk.phase_split``)."""
    kv = _stacked_clone(torch, mk, st)
    mk.phase_stamps(sp, x, kv, *inputs, pos, eps=eps)     # warm
    kv = _stacked_clone(torch, mk, st)
    _, stamps = mk.phase_stamps(sp, x, kv, *inputs, pos, eps=eps)
    split = mk.phase_split(stamps.cpu(), n_layers)
    del kv
    work = {k: v for k, v in split.items() if k in mk.PHASES}
    tails = sum(v for k, v in split.items() if k.endswith(' tail'))
    waits = sum(v for k, v in split.items() if k.endswith(' barrier'))
    print(f'decode_megakernel (#9) phase split, {n_layers} layers, slot {pos}'
          f' (%globaltimer, one launch, {len(stamps)} blocks): total '
          f'{split["total"]:.4f} ms = work '
          + ', '.join(f'{k} {v:.4f}' for k, v in work.items())
          + f' + idle tails {tails:.4f} + barriers {waits:.4f} + exit '
          f'{split["end"]:.4f} ms; grid barriers a step '
          f'{mk.fused_decode_step.barriers} [{card}]')
    print('  per phase (work / tail / barrier ms): '
          + '; '.join(f'{k} {split[k]:.4f} / {split[k + " tail"]:.4f} / '
                      f'{split[k + " barrier"]:.4f}' for k in mk.PHASES))


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

    # #10: f32 sums in another order (the splits added in split order by
    # the last CTA of each column tile, so two calls are bitwise equal); the
    # library yardstick is tinygemm with a scale of 1 and a zero of 8, which
    # takes the unsigned nibbles as they are (the output rounded to bf16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, (kh, n) in unpack.SHAPES.items():
        x, p = unpack.make_inputs(kh, n, 'cuda', seed)
        want = unpack.unpack_matmul_reference(x, p)
        plain_ms = timer(lambda: unpack.unpack_matmul_reference(x, p))
        print(f'  #10 {shape}: plan {unpack.unpack_plan(kh, n, sms)} '
              f'[{card}]')
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
        bnd = unpack.unpack_bound(kh, n)
        for v in unpack.VARIANTS:
            got = unpack.unpack_matmul(x, p, v)
            err = held(f'int4 unpack probe (#10) {v} {shape} KH={kh} N={n}',
                       got, want, 1e-5 * want.abs().max(), '1e-5*max|plain|')
            same = torch.equal(got, unpack.unpack_matmul(x, p, v))
            print(f'  two calls bitwise equal: {same} [{card}]')
            if not same:
                fail(f'int4 unpack probe {v} {shape}: two calls differ')
            ms = timer(lambda: unpack.unpack_matmul(x, p, v))
            print(f'  kernel {ms * 1e3:.1f} us ({kh * n / ms / 1e6:.0f} GB/s '
                  f'packed, {bnd[0] / ms * 100:.1f} % of the bound), plain '
                  f'{plain_ms * 1e3:.1f} us, bound {bnd[0] * 1e3:.1f} us '
                  f'({bnd[1]}) [{card}]')
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
            print(f'  kernel {ms:.4f} ms per layer ({bnd[0] / ms * 100:.1f} % '
                  f'of the bound), plain {plain_ms:.4f} ms, bound '
                  f'{bnd[0]:.4f} ms ({bnd[1]}) [{card}]')
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


def served_device_profile(torch, worker, image, prompt: str, new: int):
    """One request of ``new`` tokens under torch.profiler -> (its stats,
    device ms, {kernel: device ms})."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        frames = list(worker.generate_stream(
            {'image': image, 'prompt': prompt, 'max_new_tokens': new}))
        torch.cuda.synchronize()
    if any(f['error_code'] != 0 for f in frames):
        fail(f'profiled request: error frame {frames[-1]}')
    by_name = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA' and e.device_time > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return dict(worker.generator.last_stats), sum(by_name.values()), by_name


def serve_full_width(torch, np, seed: int, card: str):
    """Three requests through the port's ModelWorker at full width, then
    one warm prefill and one short request under torch.profiler."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
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
    prompts = SERVED_PROMPTS
    zero_counts()

    def counts():
        n = device_launches()
        return (n['int8_matmul'], n['int8_matmul.prefill'],
                n['int8_decode_attention'])
    twin = GraphTwin(torch)
    want_step = {'int8_matmul': 4 * n_layers + 1,
                 'int8_decode_attention': n_layers}
    # the decode attention's mask bias of the last decode forward (the
    # slots its kernel reads), kept by reference: no copy, no sync
    import groma_tpu_torch.models.llama_quant as llama_quant
    last_bias = []

    def recording(q, k8, ks, v8, vs, mask_bias):
        if not last_bias or last_bias[-1] is not mask_bias:
            last_bias[:] = [mask_bias]
        return int8_decode_attention(q, k8, ks, v8, vs, mask_bias)
    llama_quant.int8_decode_attention = recording
    ptwin = PrefillTwin(torch)
    for i, prompt in enumerate(prompts):
        image = random_image(np, seed + 1 + i, cfg.perceiver.image_size)
        request = {'image': image, 'prompt': prompt,
                   'max_new_tokens': MAX_NEW_TOKENS}
        before, warm0 = counts(), warmups()
        if i == 0:
            twin.arm('toks')
            ptwin.arm({'_prefill': flip_images})
        try:
            frames = list(worker.generate_stream(request))
        finally:
            twin.disarm()
            ptwin.disarm()
        torch.cuda.synchronize()
        mm, pre, att = (a - b for a, b in zip(counts(), before))
        warm = warmups() - warm0
        final = frames[-1]
        if any(f['error_code'] != 0 for f in frames):
            fail(f'request {i}: error frame {final}')
        stats = worker.generator.last_stats
        f_fwd = stats['decode_forwards']
        # the prefill's 4L layer matmuls (M = 2048) on the prefill tile,
        # its head (M = 1) and every decode forward's 4L + 1 on the decode
        # tile; a new prefill graph's warm-up runs the prefill once more
        want_pre = 4 * n_layers * (1 + warm)
        want_mm = (4 * n_layers + 1) * (1 + f_fwd + warm)
        want_att = f_fwd * n_layers
        toks = stats['tokens']
        mask = stats['selected_mask'][0]
        problems = _answer_problems(np, frames, stats, vocab)
        if stats['prefill_mode'] != 'captured' or warm != (i == 0):
            problems.append(f'prefill {stats["prefill_mode"]}, {warm} new '
                            f'prefill graphs (want captured, one at the '
                            f'first request only)')
        if (mm, pre, att) != (want_mm, want_pre, want_att):
            problems.append(f'launches int8_matmul {mm} (want {want_mm}), '
                            f'of them the prefill tile {pre} (want '
                            f'{want_pre}), decode attention {att} (want '
                            f'{want_att})')
        if problems:
            fail(f'request {i}: ' + '; '.join(problems))
        # the bias the captured step's attention reads, which every replay
        # (this request's and later ones') rewrites in place
        kept = (_read_rows(last_bias[0]) if last_bias and f_fwd
                else 'no decode forward')
        print(f'request {i}: error_code 0, {toks.shape[1]} tokens, '
              f'{len(final["boxes"])} boxes in the answer, '
              f'{int(mask.sum())} regions kept; prefill (a replay'
              f'{WARM_NOTE if warm else ""}'
              f') {stats["prefill_ms"]:.1f} ms, decode '
              f'{stats["decode_ms_per_token"]:.2f} ms/token over '
              f'{f_fwd} forwards (host clock; a new graph\'s warm-up step '
              f'and capture included); launches int8_matmul {mm} (prefill '
              f'tile {pre}), decode attention {att}; slots the last decode '
              f'forward\'s attention read: {kept} of '
              f'{worker.generator.max_len} [{card}]')
        if i == 0:
            print(ptwin.line('served path (QuantGenerator, int8 + kv8)',
                             '_prefill', card))
            print(twin.line('served path (QuantGenerator, int8 + kv8)',
                            card))
            if twin.result['delta'] != want_step:
                fail(f'served path: a replay launches '
                     f'{twin.result["delta"]}, want {want_step}')
    llama_quant.int8_decode_attention = int8_decode_attention
    launched = counts()
    # warm: the same image and prompt, a prefill alone (one new token)
    # and a prefill with decode forwards, each under torch.profiler; the
    # difference is the decode's device time
    image = random_image(np, seed + 1, cfg.perceiver.image_size)
    pre_stats, pre_ms, by_name = served_device_profile(
        torch, worker, image, prompts[0], 1)
    dec_stats, dec_ms, _ = served_device_profile(
        torch, worker, image, prompts[0], 9)
    top = ', '.join(f'{k[:56]} {v:.2f}' for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:8])
    tiles = sum(v for k, v in by_name.items() if 'int8_prefill_kernel' in k)
    fwd = dec_stats['decode_forwards']
    per_token = (f'{(dec_ms - pre_ms) / fwd:.3f} ms of device time a '
                 f'decode token ({fwd} forwards)' if fwd else
                 'no decode forward ran (an early end of sequence)')
    print(f'served path, warm prefill ({pre_stats["prefill_mode"]}) under '
          f'torch.profiler: host {pre_stats["prefill_ms"]:.1f} ms, '
          f'{pre_ms:.2f} ms of device time (host / device '
          f'{pre_stats["prefill_ms"] / pre_ms:.3f}), of it the int8 prefill '
          f'tile {tiles:.2f} ms; the longest kernels, ms: {top} [{card}]')
    print(f'served path, the same request with 9 new tokens: '
          f'{per_token} [{card}]')
    return launched, worker


# ----------------------------------------------- W8A8 and speculation

def _cpu_equal(torch, pairs) -> bool:
    """Each (card tensor, CPU tensor) pair equal bit for bit."""
    return all(torch.equal(a.cpu(), b) for a, b in pairs)


def check_w8a8_matmul(torch, gen, timer, card):
    """The W8A8 product (ops/quant.w8a8_matmul: the activations quantized
    per row, torch._int_mm, the rescale) at the four layer matmuls, M =
    2048 (the served prefill) and 576 (the compacted REC stream), on the
    K-major weight copy and on the stored layout, every case held three
    ways: bitwise equal to the plain version on the card (the exact
    product in f64: CUDA has no int32 matmul); its int8 activations and
    row scales equal to quantize_act's on CPU copies; and its output equal
    to the card's exact sums rescaled on the CPU with those scales.  At
    M=576 o_proj also against the whole plain version on CPU copies (an
    int32 matmul).  Its time beside the product alone, the per-call
    transpose the copy saves, #1's prefill tile on the same inputs, and
    the int8 and bf16 bounds.  Returns {M: (w8a8 ms, #1 ms, int8 bound
    ms)} over the four matmuls."""
    from groma_tpu_torch.ops.quant import (_rescale_rows, int8_matmul,
                                           int_product, quantize_act,
                                           quantize_weight, w8a8_matmul,
                                           w8a8_matmul_reference,
                                           w8a8_weight)
    dev = gen.device
    sums = {}
    for m in W8A8_ROWS:
        acc = sums.setdefault(m, [0.0] * 7)
        for name in LAYER_MATMULS:
            k, n = INT8_MATMUL_SHAPES[name]
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            wq, scale = quantize_weight(torch.randn((k, n), generator=gen,
                                                    device=dev))
            wk = w8a8_weight(wq)
            want = w8a8_matmul_reference(x, wq, scale)
            got = w8a8_matmul(x, wk, scale)
            ok = all(torch.equal(g, want) for g in (
                got, w8a8_matmul(x, wk, scale), w8a8_matmul(x, wq, scale)))
            ok = ok and bool(torch.isfinite(got.float()).all())
            # the quantization and the rescale against CPU copies
            xq, xs = quantize_act(x)
            xq_c, xs_c = quantize_act(x.cpu())
            quant_ok = _cpu_equal(torch, ((xq, xq_c), (xs, xs_c)))
            rescale_ok = _cpu_equal(torch, ((got, _rescale_rows(
                int_product(xq, wq).cpu(), xs_c, scale.cpu(), x.dtype)),))
            ok = ok and quant_ok and rescale_ok
            cpu_note = ''
            if m == W8A8_ROWS[-1] and name == 'o_proj':
                # the whole plain version on CPU copies: an int32 matmul
                same = torch.equal(w8a8_matmul_reference(
                    x.cpu(), wq.cpu(), scale.cpu()), got.cpu())
                ok = ok and same
                cpu_note = (f'; {"equal" if same else "NOT equal"} to the '
                            f'whole plain version on CPU copies (an int32 '
                            f'matmul)')
            ms = timer(lambda: w8a8_matmul(x, wk, scale))
            stored_ms = timer(lambda: w8a8_matmul(x, wq, scale))
            prod_ms = timer(lambda: torch._int_mm(xq, wk))
            tr_ms = timer(lambda: wq.T.contiguous())
            tile_ms = timer(lambda: int8_matmul(x, wq, scale))
            plain_ms = timer(lambda: w8a8_matmul_reference(x, wq, scale))
            nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
            b8, by8 = bound(nbytes, 2 * m * k * n, H100_INT8_OPS)
            b16, by16 = bound(nbytes, 2 * m * k * n)
            for i, v in enumerate((ms, stored_ms, prod_ms, tr_ms, tile_ms,
                                   plain_ms, b8)):
                acc[i] += v
            print(f'w8a8_matmul M={m} {name} K={k} N={n}: bitwise equal to '
                  f'its plain version on the K-major copy and on the stored '
                  f'layout {"ok" if ok else "FAIL"} (quantize_act on CPU '
                  f'copies {"equal" if quant_ok else "NOT equal"}, the '
                  f'exact sums rescaled on the CPU '
                  f'{"equal" if rescale_ok else "NOT equal"}{cpu_note}); '
                  f'{ms:.4f} ms '
                  f'(K-major copy; the product alone {prod_ms:.4f}), '
                  f'{stored_ms:.4f} ms on the stored (K, N) layout, the '
                  f'per-call transpose {tr_ms:.4f} ms; #1\'s prefill tile '
                  f'{tile_ms:.4f} ms; plain {plain_ms:.4f} ms; int8 bound '
                  f'{b8:.4f} ms ({by8}), bf16 bound {b16:.4f} ms ({by16}) '
                  f'[{card}]')
            if not ok:
                fail(f'w8a8_matmul differs from its plain version at M={m} '
                     f'{name}')
            del x, wq, wk, want, got, xq, xq_c
    for m, a in sums.items():
        print(f'w8a8_matmul M={m}, the four layer matmuls: {a[0]:.4f} ms '
              f'(K-major copy; the products alone {a[2]:.4f}), {a[1]:.4f} '
              f'ms on the stored layout, per-call transposes {a[3]:.4f} '
              f'ms; #1\'s prefill tile {a[4]:.4f} ms ({a[0] / a[4]:.3f} x); '
              f'plain {a[5]:.4f} ms; int8 bound {a[6]:.4f} ms, '
              f'{100 * a[6] / a[0]:.1f} % of it [{card}]')
    return {m: (a[0], a[4], a[6]) for m, a in sums.items()}


def check_w8a8_conv(torch, gen, timer, card):
    """The int8 vision convs (ops/quant.w8a8_conv): the three input pieces
    of a fuse conv at each level (128², 64², 32²) and the RoI head's conv
    over 100 RoIs of 14² and the levels' 3072 channels, 1024 outputs,
    every case held three ways: bitwise equal to the plain version on the
    card (F.unfold and the exact product in f64); its int8 activations,
    kernel and scales equal to quantize_tensor's and quantize_conv_kernel's
    on CPU copies; and its output equal to the card's exact sums rescaled
    on the CPU with those scales.  The 32² pieces also against the whole
    plain version on CPU copies (int32).  The conv's time, its products
    over the im2col matrix, a bf16 F.conv2d (cuDNN) of the same shape and
    the int8 bound.  Returns the ms of one image's int8 convs, their
    products, cuDNN's and the bound."""
    import torch.nn.functional as F
    from groma_tpu_torch.ops.quant import (_im2col_products,
                                           _rescale_channels,
                                           conv_sums_reference,
                                           quantize_conv_kernel,
                                           quantize_tensor, w8a8_conv,
                                           w8a8_conv_reference)
    dev = gen.device
    co = 1024
    total = dict.fromkeys(('w8a8_conv', 'products', 'cudnn', 'bound'), 0.0)
    for name, b, c, hw, per_image in W8A8_CONV_CASES:
        x = torch.randn((b, c, hw, hw), generator=gen, device=dev).to(
            torch.bfloat16)
        wt = (torch.randn((co, c, 3, 3), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        want = w8a8_conv_reference(x, wt)
        got = w8a8_conv(x, wt)
        ok = torch.equal(got, want) and bool(torch.isfinite(want).all())
        # the quantization and the rescale against CPU copies
        xq, xs = quantize_tensor(x)
        kq, ks = quantize_conv_kernel(wt)
        xq_c, xs_c = quantize_tensor(x.cpu())
        kq_c, ks_c = quantize_conv_kernel(wt.cpu())
        quant_ok = _cpu_equal(torch, ((xq, xq_c), (xs, xs_c), (kq, kq_c),
                                      (ks, ks_c)))
        rescaled = _rescale_channels(conv_sums_reference(xq, kq).cpu(),
                                     xs_c, ks_c)
        rescale_ok = torch.equal(rescaled.reshape(b, hw, hw, co),
                                 got.cpu().permute(0, 2, 3, 1))
        ok = ok and quant_ok and rescale_ok
        cpu_note = ''
        if b * hw * hw * c <= W8A8_CONV_CPU_ELEMENTS:
            # the whole plain version on CPU copies: unfold and int32
            same = torch.equal(w8a8_conv_reference(x.cpu(), wt.cpu()),
                               got.cpu())
            ok = ok and same
            cpu_note = (f'; the whole plain version on CPU copies (an int32 '
                        f'product) {"equal" if same else "NOT equal"}')
        ms = {'w8a8_conv': timer(lambda: w8a8_conv(x, wt)),
              'products': timer(lambda: _im2col_products(xq, kq)),
              'cudnn': timer(lambda: F.conv2d(x, wt, padding=1))}
        plain_ms = timer(lambda: w8a8_conv_reference(x, wt), iters=3)
        ops = 2 * b * hw * hw * 9 * c * co
        b_ms, by = bound(2 * b * c * hw * hw + 2 * 9 * c * co
                         + 4 * b * hw * hw * co, ops, H100_INT8_OPS)
        for key in ms:
            total[key] += per_image * ms[key]
        total['bound'] += per_image * b_ms
        print(f'w8a8_conv {name} (B={b}, C={c}, {hw}x{hw}, {co} out): '
              f'bitwise equal to the plain version {"ok" if ok else "FAIL"} '
              f'(quantization on CPU copies '
              f'{"equal" if quant_ok else "NOT equal"}, the exact sums '
              f'rescaled on the CPU {"equal" if rescale_ok else "NOT equal"}'
              f'{cpu_note}); {ms["w8a8_conv"]:.4f} ms '
              f'({ops / ms["w8a8_conv"] / 1e9:.1f} TOP/s), its products '
              f'over the im2col matrix {ms["products"]:.4f} ms; bf16 '
              f'F.conv2d (cuDNN) {ms["cudnn"]:.4f} ms; plain '
              f'{plain_ms:.4f} ms; int8 bound {b_ms:.4f} ms ({by}) '
              f'[{card}]')
        if not ok:
            fail(f'w8a8_conv differs from its plain version at {name}')
        del x, wt, want, got, xq, kq, xq_c, kq_c, rescaled
    print(f'w8a8_conv, one image\'s int8 vision convs (5 fuse rounds of 9 '
          f'pieces and the RoI head): {total["w8a8_conv"]:.3f} ms (the '
          f'products over the im2col matrix {total["products"]:.3f} ms), '
          f'the same shapes in bf16 through cuDNN {total["cudnn"]:.3f} ms, '
          f'int8 bound {total["bound"]:.3f} ms [{card}]')
    return total


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def int8_vision_model(torch, model):
    """``model``'s GromaModel rebuilt under ``GromaConfig(vision_int8=
    True)``, every parameter shared (the int8 convs read the same float
    weights)."""
    from groma_tpu_torch.models.groma import GromaModel
    m8 = GromaModel(model.cfg.replace(vision_int8=True), device='meta')
    m8.load_state_dict(model.state_dict(), assign=True)
    if not m8.region_encoder.quant:
        fail('GromaModel(vision_int8=True) built float convs')
    return m8.eval()


def _counts_now():
    """The launches this phase checks, by name: launches that ran on the
    device (``device_launches``), replays of captured prefills included."""
    ran = device_launches()
    return {'flash bidirectional': ran['flash_fwd.bidirectional'],
            'flash causal': ran['flash_fwd.causal'],
            'w8a8_matmul': ran['w8a8_matmul'],
            'w8a8_conv': ran['w8a8_conv'],
            'int8_matmul': ran['int8_matmul'],
            'int8 prefill tile': ran['int8_matmul.prefill']}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts_now().items()}


def _device_ms(torch, fn):
    """``fn()`` once under torch.profiler -> (its result, device ms, the
    longest kernels as text)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    _sync(torch)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = fn()
        _sync(torch)
    by_name = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA' and e.device_time > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = ', '.join(f'{k[:48]} {v:.2f}' for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:6])
    return out, sum(by_name.values()), top


def rec_e2e_full_width(torch, np, m8, qp, kmajor, seed: int, card: str):
    """JAX's end-to-end REC configuration (benchmarks/bench_e2e.py --w8a8
    --int8vision, B=1): build_rec_prompt into a 640-slot stream, vision
    with the flash kernels and the int8 convs, check_stream_capacity, the
    stream compacted to 576 slots, the W8A8 prefill (576 < FLASH_MIN_SEQ:
    dense attention, as in JAX) into a bf16 cache of 584, then 3 greedy
    decode steps.  ms per image on the host clock over synchronized runs,
    device time under torch.profiler, exact launch counts.  ``kmajor``:
    the W8A8 products' K-major weights (llama_quant.w8a8_weights)."""
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu_torch.eval.generate_quant import quant_embed, quant_logits
    from groma_tpu_torch.eval.rec import build_rec_prompt
    from groma_tpu_torch.models.groma import (_gather_valid_first,
                                              _ordinal,
                                              check_stream_capacity)
    from groma_tpu_torch.models.llama import make_kv_cache
    from groma_tpu_torch.models.llama_quant import quant_llama_forward
    from groma_tpu_torch.utils.graphs import CallGraph
    cfg = m8.cfg
    llm = cfg.llm
    dev = qp['norm'].device
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=REC_SEQ_LEN,
                      image_size=cfg.perceiver.image_size)
    t = build_rec_prompt('the red object on the left',
                         StableStubTokenizer(base_vocab=llm.vocab_size), spec)
    image = torch.as_tensor(random_image(np, seed + 40,
                                         cfg.perceiver.image_size)[None],
                            device=dev)
    ids, slot, valid0 = (torch.as_tensor(t[k][None], device=dev)
                         for k in ('input_ids', 'region_slot', 'valid'))
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    prefills = CallGraph()

    def rec_prefill(_, image, ids, slot, valid0):
        """bench_e2e's prefill, one captured program: vision (#3, the int8
        convs), the stream compacted (its capacity checked once, below),
        the W8A8 prefill into a fresh cache, the first logits."""
        emb, _, valid, vis = m8.prepare_stream(image, ids, slot, valid0,
                                               use_flash=True)
        emb, valid = _gather_valid_first(emb, valid, REC_PREFILL_LEN)
        pos = _ordinal(valid).clamp(min=0)
        cache = make_kv_cache(llm, 1, REC_PREFILL_LEN + 8, device=dev)
        hidden, cache = quant_llama_forward(qp, llm, emb, valid, pos, cache,
                                            use_flash=True, w8a8=True,
                                            kmajor=kmajor)
        # B = 1: index_select, as a 0-d index would be read on the host
        last = torch.argmax(pos, dim=-1)
        logits = quant_logits(qp, hidden.index_select(1, last))[:, 0]
        return logits, pos.index_select(1, last) + 1, cache, \
            vis['selected_boxes']

    def e2e():
        logits, pos0, cache, boxes = prefills.run(rec_prefill, None, image,
                                                  ids, slot, valid0)
        cache['index'] = REC_PREFILL_LEN      # a replay sets no host value
        toks = []
        for i in range(REC_DECODE_STEPS):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            hidden, cache = quant_llama_forward(
                qp, llm, quant_embed(qp, tok[:, None], llm.vocab_size),
                ones, pos0 + i, cache)
            logits = quant_logits(qp, hidden)[:, -1]
        return torch.stack(toks, 1), boxes, logits

    ptwin = PrefillTwin(torch)
    with torch.inference_mode():
        _, _, valid, _ = m8.prepare_stream(image, ids, slot, valid0,
                                           use_flash=True)
        n_valid = int(valid.sum())
        check_stream_capacity(valid, REC_PREFILL_LEN)
        t0 = time.perf_counter()
        e2e()                  # the warm-up run: the prefill's capture
        _sync(torch)
        first_ms = (time.perf_counter() - t0) * 1e3
        before = _counts_now()
        ptwin.arm({'rec_prefill': flip_images})
        try:
            toks, boxes, logits = e2e()          # its first replay
        finally:
            ptwin.disarm()
        _sync(torch)
        moved = _moved(before)
        n_layers = llm.num_layers
        want = {'flash bidirectional': cfg.perceiver.vit.num_layers,
                'flash causal': 0, 'w8a8_matmul': 4 * n_layers,
                'w8a8_conv': cfg.region_num_fuse * 9 + 1,
                'int8_matmul': 1 + REC_DECODE_STEPS * (4 * n_layers + 1),
                'int8 prefill tile': 0}
        _sync(torch)
        t0 = time.perf_counter()
        for _ in range(REC_RUNS):
            toks, boxes, logits = e2e()
            _sync(torch)
        ms = (time.perf_counter() - t0) * 1e3 / REC_RUNS
        (toks, boxes, logits), dev_ms, top = _device_ms(torch, e2e)
    print(ptwin.line('REC end to end', 'rec_prefill', card))
    toks_np = toks.cpu().numpy()
    boxes_np = boxes.float().cpu().numpy()
    ok = (moved == want and np.isfinite(boxes_np).all()
          and bool(torch.isfinite(logits).all())
          and ((toks_np >= 0) & (toks_np < cfg.vocab_size)).all())
    print(f'REC end to end (bench_e2e --w8a8 --int8vision, B=1): '
          f'{n_valid} valid tokens of {REC_SEQ_LEN} compacted to '
          f'{REC_PREFILL_LEN}; {ms:.1f} ms per image (host clock, '
          f'{REC_RUNS} synchronized runs; {1e3 / ms:.2f} images/s; the '
          f'prefill a replay, the {REC_DECODE_STEPS} decode steps eager; '
          f'the first run, with the capture, {first_ms:.1f} ms), '
          f'{dev_ms:.2f} ms of device time (torch.profiler, one run); the '
          f'longest kernels, ms: {top}; launches of a run {moved} '
          f'({"exact" if moved == want else f"want {want}"}); tokens '
          f'{toks_np[0].tolist()}, selected boxes '
          f'{"finite" if np.isfinite(boxes_np).all() else "NOT finite"} '
          f'[{card}]')
    if not ok:
        fail('REC end to end: launches, tokens or boxes wrong')
    return ms, dev_ms


def _cosine(np, a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def serve_w8a8_full_width(torch, np, worker, gen8, seed: int, card: str):
    """``gen8``, QuantGenerator(kv_bits=8, use_flash=True,
    w8a8_prefill=True) under GromaConfig(vision_int8=True) on the served
    path's weights, on its three requests: launches exact (#3 24 an
    image, #4 32 a prefill at S=2048, W8A8 4L, the int8 convs 46, #1's
    prefill tile none), the first logits
    against the weight-only prefill's (cosine >= W8A8_COSINE_MIN, argmax
    agreement), every logit finite; prefill device time by kernel."""
    from groma_tpu_torch.eval.generate_quant import QuantGenerator
    from groma_tpu_torch.serve.worker import expand_request
    base = worker.generator
    cfg = gen8.cfg
    n_layers = cfg.llm.num_layers
    eos = worker.tokenizer.sp.eos
    want = {'flash bidirectional': cfg.perceiver.vit.num_layers,
            'flash causal': n_layers, 'w8a8_matmul': 4 * n_layers,
            'w8a8_conv': cfg.region_num_fuse * 9 + 1,
            'int8 prefill tile': 0}
    requests = []
    ptwin = PrefillTwin(torch)
    for i, prompt in enumerate(SERVED_PROMPTS):
        t = expand_request(worker.tokenizer, worker.spec, {'prompt': prompt})
        image = random_image(np, seed + 1 + i, cfg.perceiver.image_size)
        args = (image[None], t['input_ids'][None], t['region_slot'][None],
                t['valid'][None])
        requests.append(args)
        base.generate(*args, max_new_tokens=1, eos_id=eos)
        ref = base.last_stats['first_logits']
        before, warm0 = _counts_now(), warmups()
        if i == 0:
            ptwin.arm({'_prefill': flip_images})
        try:
            tokens, vis = gen8.generate(*args, max_new_tokens=MAX_NEW_TOKENS,
                                        eos_id=eos)
        finally:
            ptwin.disarm()
        _sync(torch)
        moved = _moved(before)
        # a new prefill graph's warm-up runs the prefill once more
        warm = warmups() - warm0
        st = gen8.last_stats
        first = st['first_logits']
        cos = _cosine(np, first, ref)
        agree = float(np.mean(first.argmax(-1) == ref.argmax(-1)))
        problems = []
        got = {k: moved[k] for k in want}
        if got != {k: v * (1 + warm) for k, v in want.items()}:
            problems.append(f'launches {got}, want {want} x {1 + warm}')
        if st['prefill_mode'] != 'captured' or warm != (i == 0):
            problems.append(f'prefill {st["prefill_mode"]}, {warm} new '
                            f'prefill graphs (want captured, one at the '
                            f'first request only)')
        if not (st['logits_finite'] and np.isfinite(first).all()):
            problems.append('non-finite logits')
        if not cos >= W8A8_COSINE_MIN:
            problems.append(f'first logits cosine {cos:.4f} against the '
                            f'weight-only prefill\'s < {W8A8_COSINE_MIN}')
        if not (((tokens >= 0) & (tokens < cfg.vocab_size)).all()
                and vis['selected_mask'].any()
                and np.isfinite(vis['selected_boxes']).all()):
            problems.append('tokens or selected boxes malformed')
        print(f'W8A8 request {i} (QuantGenerator kv8, use_flash, '
              f'w8a8_prefill, vision_int8): {tokens.shape[1]} tokens; '
              f'prefill {st["prefill_ms"]:.1f} ms, decode '
              f'{st["decode_ms_per_token"]:.2f} ms/token over '
              f'{st["decode_forwards"]} forwards (host clock); first logits '
              f'against the weight-only prefill\'s: cosine {cos:.5f}, argmax '
              f'{"agrees" if agree == 1.0 else "differs"}; launches {got} '
              f'({"exact" if not problems else "WRONG"}'
              f'{", with the warm-up" if warm else ""}), decode tile '
              f'{moved["int8_matmul"]} [{card}]')
        if problems:
            fail(f'W8A8 request {i}: ' + '; '.join(problems))
        if i == 0:
            print(ptwin.line('W8A8 + flash + vision_int8 (QuantGenerator)',
                             '_prefill', card))
    # warm prefills under torch.profiler, the same request: W8A8 + flash +
    # int8 vision, flash alone (weight-only, float vision), the served one
    flash = QuantGenerator(base.model, base.qp, max_len=base.max_len,
                           kv_bits=8, use_flash=True)
    for name, g in (('w8a8_prefill + use_flash + vision_int8', gen8),
                    ('use_flash (weight-only, float vision)', flash),
                    ('weight-only, dense (the served path)', base)):
        # the key's capture first: the profiled prefill is a replay
        g.generate(*requests[0], max_new_tokens=1, eos_id=eos)
        _, dev_ms, top = _device_ms(
            torch, lambda: g.generate(*requests[0], max_new_tokens=1,
                                      eos_id=eos))
        host = g.last_stats['prefill_ms']
        print(f'prefill {name}, warm, under torch.profiler: host '
              f'{host:.1f} ms, {dev_ms:.2f} ms of device time (host / device '
              f'{host / dev_ms:.3f}; {g.last_stats["prefill_mode"]}); the '
              f'longest kernels, ms: {top} [{card}]')
    del flash
    return requests


def _first_difference(a, b) -> int:
    n = min(len(a), len(b))
    for j in range(n):
        if a[j] != b[j]:
            return j
    return n


class LogitRecorder:
    """The logits of a captured step, kept: ``wrap(fn)`` is ``fn`` that
    also copies its output into the next of ``cap`` rows of a device
    buffer, the row counter a device word, so that every replay of a graph
    captured over it records as an eager step does (the copy launches no
    kernel of the port).  ``reset()`` starts the count again."""

    def __init__(self, torch, cap: int):
        self.torch, self.cap = torch, cap
        self.buf = self.calls = None

    def wrap(self, fn):
        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.record(out)
            return out
        return recording

    def record(self, logits):
        torch = self.torch
        if self.buf is None:        # the first call: an eager warm-up step
            self.buf = torch.zeros((self.cap,) + tuple(logits.shape),
                                   dtype=logits.dtype, device=logits.device)
            self.calls = torch.zeros((), dtype=torch.int64,
                                     device=logits.device)
        self.buf.index_copy_(0, self.calls.remainder(self.cap).view(1),
                             logits[None])
        self.calls.add_(1)

    def reset(self):
        if self.calls is not None:
            with self.torch.inference_mode():    # made in a step's
                self.calls.zero_()

    def row(self, i: int):
        """The logits of call ``i`` since the last reset."""
        n = 0 if self.calls is None else int(self.calls)
        if not 0 <= i < n or n > self.cap:
            fail(f'logit recorder: call {i} of {n} not kept (room for '
                 f'{self.cap})')
        return self.buf[i]


def _is_max(logits, tok: int, slack: float = 0.0) -> bool:
    """Whether ``logits[tok]`` is at most ``slack`` below their maximum
    (ties counted)."""
    return bool(logits[tok] >= logits.max() - slack)


def _bf16_step(x: float) -> float:
    """One step of bf16 at the magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _parted_at_near_tie(ref, got, ref_tok: int, got_tok: int, diff_max: float,
                        ref_slack: float = 0.0, got_slack: float = 0.0):
    """Two paths' logits where their tokens first part (``ref`` picked
    ``ref_tok``, ``got`` picked ``got_tok``) -> (top-2 gap of ``ref``,
    max |got - ref|, whether it is a near-tie): each path's own pick a
    maximum of its own logits (within its slack), the other's pick at most
    twice the difference below that maximum, and the gap below the
    difference, which is at most ``diff_max``."""
    diff = (got - ref).abs().max().item()
    top2 = ref.topk(2).values
    gap = (top2[0] - top2[1]).item()
    tie = (diff <= diff_max and gap < diff
           and _is_max(ref, ref_tok, ref_slack)
           and _is_max(got, got_tok, got_slack)
           and _is_max(ref, got_tok, 2 * diff)
           and _is_max(got, ref_tok, 2 * diff))
    return gap, diff, tie


def _sequential_logits(torch, model, qp, max_len, args, toks, j: int):
    """The sequential greedy decode's logits at token j (the forward of
    token j-1 on the cache of the prompt and tokens 0..j-2), recomputed as
    QuantGenerator's decode step computes them, at b=1 on an int8 cache of
    ``max_len`` slots."""
    from groma_tpu_torch.eval.generate_quant import quant_embed, quant_logits
    from groma_tpu_torch.models.groma import _ordinal
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_forward)
    llm = model.cfg.llm
    dev = qp['norm'].device
    vocab = llm.vocab_size
    with torch.inference_mode():
        images, ids, slot, valid0 = (torch.as_tensor(a, device=dev)
                                     for a in args)
        emb, _, valid, _ = model.prepare_stream(images.float(), ids.long(),
                                                slot.long(), valid0)
        pos = _ordinal(valid).clamp(min=0)
        cache = make_quant_kv_cache(llm, 1, max_len, device=dev)
        quant_llama_forward(qp, llm, emb, valid, pos, cache)
        pos0 = int(pos.max()) + 1
        one = torch.ones((1, 1), dtype=torch.bool, device=dev)
        for i in range(j):
            h, _ = quant_llama_forward(
                qp, llm, quant_embed(qp, torch.tensor([[int(toks[i])]],
                                                      device=dev), vocab),
                one, torch.tensor([[pos0 + i]], device=dev), cache)
        return quant_logits(qp, h)[0, -1].float()


def _verify_logits(rec: LogitRecorder, accepted, j: int):
    """The logits a speculative generation picked its token j from: the
    row of the verify call that emitted it, as the call recorded it (token
    0 is the prefill's; call c emits accepted[c] + 1 tokens)."""
    done = 1
    for call, acc in enumerate(accepted):
        if j <= done + acc:
            return rec.row(call)[0, j - done].float()
        done += acc + 1
    fail(f'speculative path: no verify call emitted token {j}')


def serve_speculative_full_width(torch, np, worker, requests, seed: int,
                                 card: str):
    """QuantGenerator(kv_bits=8, spec_lookahead=SPEC_LOOKAHEAD) on the
    served path's weights and three requests: verify calls, accepted per
    call, ms/token, the tokens against the sequential greedy ones: equal,
    or differing first at a near-tie (``_parted_at_near_tie``) between the
    verify row's logits that picked the speculative token, as the captured
    verify recorded them, and the sequential decode's, recomputed (their
    own pick within one bf16 step of their maximum), at most
    SPEC_LOGIT_DIFF_MAX apart; then the verify step's replays against the
    eager step on a copy of its state."""
    import groma_tpu_torch.eval.generate_quant as generate_quant
    from groma_tpu_torch.eval.generate_quant import QuantGenerator
    from groma_tpu_torch.eval.speculative import propose_prompt_lookup
    from groma_tpu_torch.utils import graphs
    base = worker.generator
    G = SPEC_LOOKAHEAD
    spec = QuantGenerator(base.model, base.qp, max_len=base.max_len,
                          kv_bits=8, spec_lookahead=G)
    # the verify step made over a recording logits head: each call keeps
    # its (G + 1)-row logits, a generation makes at most MAX_NEW_TOKENS
    rec = LogitRecorder(torch, MAX_NEW_TOKENS)
    logits_fn = generate_quant.quant_logits
    generate_quant.quant_logits = rec.wrap(logits_fn)
    try:
        spec.verifier()
    finally:
        generate_quant.quant_logits = logits_fn
    eos = worker.tokenizer.sp.eos
    for i, args in enumerate(requests):
        seq_tokens, _ = base.generate(*args, max_new_tokens=MAX_NEW_TOKENS,
                                      eos_id=eos)
        seq_ms = base.last_stats['decode_ms_per_token']
        rec.reset()
        tokens, _ = spec.generate(*args, max_new_tokens=MAX_NEW_TOKENS,
                                  eos_id=eos)
        st, stats = spec.spec_stats, spec.last_stats
        acc = st['accepted']
        line = (f'speculative request {i} (QuantGenerator kv8, '
                f'spec_lookahead={G}): {tokens.shape[1]} tokens in '
                f'{st["verify_calls"]} verify calls, accepted per call '
                f'{np.mean(acc) if acc else 0:.2f} (max {max(acc, default=0)}'
                f'), {st["tokens_per_call"]} tokens a call; '
                f'{stats["decode_ms_per_token"]:.2f} ms/token (host clock) '
                f'against {seq_ms:.2f} sequential')
        a, b = tokens[0].tolist(), seq_tokens[0].tolist()
        if a == b:
            print(f'{line}; tokens equal to the sequential greedy tokens '
                  f'[{card}]')
            continue
        j = _first_difference(a, b)
        if not 1 <= j < min(len(a), len(b)):
            fail(f'{line}; tokens differ from the sequential ones in '
                 f'length only ({len(a)} against {len(b)})')
        seq = _sequential_logits(torch, base.model, base.qp, base.max_len,
                                 args, b, j)
        ver = _verify_logits(rec, acc, j)
        gap, diff, tie = _parted_at_near_tie(
            seq, ver, b[j], a[j], SPEC_LOGIT_DIFF_MAX,
            ref_slack=_bf16_step(seq.max().item()))
        print(f'{line}; tokens first differ from the sequential ones at '
              f'{j} ({a[j]} against {b[j]}): the sequential top-2 logit gap '
              f'there {gap:.4e}, |verify - decode logits| {diff:.4e} (at '
              f'most {SPEC_LOGIT_DIFF_MAX}); logits of the two tokens in '
              f'the sequential decode {seq[b[j]].item():.4f}, '
              f'{seq[a[j]].item():.4f} (max {seq.max().item():.4f}), in the '
              f'recorded verify {ver[b[j]].item():.4f}, '
              f'{ver[a[j]].item():.4f} (max {ver.max().item():.4f}) '
              f'({"a near-tie" if tie else "NOT a near-tie"}) [{card}]')
        if not tie:
            fail(f'speculative request {i}: tokens differ from the '
                 f'sequential ones where the logits are not near a tie')
    # the verify step, replays against the eager step on a copy of the
    # state, from a fresh prefill
    args = requests[0]
    spec.generate(*args, max_new_tokens=1, eos_id=eos)
    verifier = spec.verifier()
    graph = verifier.graph
    if graph.graph is None and graph.device.type == 'cuda':
        fail('speculative path: the verify step was never captured')
    ctx = [int(t) for t, v in zip(args[1][0], args[3][0]) if v] + [
        int(verifier.state['cur'][0])]
    drafts = [propose_prompt_lookup(ctx, G)] + [
        np.random.default_rng(seed + k).integers(
            3, base.cfg.vocab_size, G).tolist()
        for k in range(SPEC_TWIN_STEPS - 1)]
    copy = _clone_tree(torch, verifier.state)

    def eager(steps):
        def go():
            for d in steps:
                copy['draft'].copy_(torch.as_tensor(d))
                graph.step(copy)
                out_eager.append(torch.cat([copy['emitted'],
                                            copy['n_accept'].view(1)]))
        return go

    def replay(steps):
        def go():
            for d in steps:
                verifier.state['draft'].copy_(torch.as_tensor(d))
                graph.run(1)
                out_graph.append(torch.cat([
                    verifier.state['emitted'],
                    verifier.state['n_accept'].view(1)]))
        return go
    out_eager, out_graph = [], []
    half = SPEC_TWIN_STEPS // 2
    eager_dev, _ = _profiled(torch, eager(drafts[:half]), half)
    eager_ms = _timed(torch, eager(drafts[half:]), SPEC_TWIN_STEPS - half)
    zero_counts()                  # the eager steps are comparison calls
    graph_dev, _ = _profiled(torch, replay(drafts[:half]), half)
    graph_ms = _timed(torch, replay(drafts[half:]), SPEC_TWIN_STEPS - half)
    per_replay = {k: v / SPEC_TWIN_STEPS
                  for k, v in device_launches().items() if v}
    same = all(torch.equal(x, y) for x, y in zip(out_eager, out_graph)) \
        and all(torch.equal(x, y) for x, y in zip(
            graphs._tensors(copy), graphs._tensors(verifier.state)))
    want = {k: float(v) for k, v in graph.delta.items()}
    print(f'speculative verify step, {SPEC_TWIN_STEPS} verifies, graph '
          f'against eager (the same step on a copy of the state): emitted '
          f'tokens, n_accept and the whole state (cache included) '
          f'{"bitwise equal" if same else "DIFFER"}; {graph_ms:.3f} against '
          f'{eager_ms:.3f} ms a verify (host clock, synchronized), device '
          f'time {graph_dev:.3f} against {eager_dev:.3f} ms (torch.profiler),'
          f' device busy {100 * graph_dev / graph_ms:.1f} % against '
          f'{100 * eager_dev / eager_ms:.1f} %; launches a replay '
          f'{per_replay} (StepGraph.device_launches; the capture counted '
          f'{graph.delta}) [{card}]')
    if not same or per_replay != want:
        fail('speculative verify step: the replays differ from the eager '
             'step, or their launches from the capture\'s')
    del spec


def serve_w8a8_and_speculation(torch, np, worker, seed: int, card: str):
    """Phase 5b on the served path's worker: JAX's REC end-to-end
    configuration, the W8A8 + flash + int8-vision generator, and
    speculative decoding."""
    from groma_tpu_torch.eval.generate_quant import QuantGenerator
    base = worker.generator
    m8 = int8_vision_model(torch, base.model)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the generator makes the K-major weight copies; the REC run reads them
    gen8 = QuantGenerator(m8, base.qp, max_len=base.max_len, kv_bits=8,
                          use_flash=True, w8a8_prefill=True)
    rec_e2e_full_width(torch, np, m8, base.qp, gen8.kmajor, seed, card)
    requests = serve_w8a8_full_width(torch, np, worker, gen8, seed, card)
    del gen8
    serve_speculative_full_width(torch, np, worker, requests, seed, card)
    print(f'W8A8 and speculation phase: {time.perf_counter() - t0:.1f} s; '
          f'device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} '
          f'GiB peak [{card}]')
    del m8


def check_bf16_llm_path(torch, seed: int, card: str):
    """The unquantized LLaMA path at full width and two layers, bf16
    weights and KV cache, on the card against the same weights and inputs
    on the CPU: a prefill, then scalar-index decode steps, then
    vector-index steps at per-row indices (the engine's)."""
    import copy
    from groma_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                              make_kv_cache)
    cfg = LlamaConfig(num_layers=2)           # Vicuna-7B width, bf16
    torch.manual_seed(seed)
    with torch.no_grad():
        llm = LlamaModel(cfg, device='cuda', linear_dtype=torch.bfloat16)
    b, s, steps, max_len = 2, 128, 4, 144
    gen = torch.Generator().manual_seed(seed)
    emb = torch.randn((b, s, cfg.hidden_size), generator=gen)
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[0, 60:90] = False                   # a pad gap: index != position
    valid[1, 100:] = False
    pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
    nxt = pos[:, -1:] + 1
    steps_in = [torch.randn((b, 1, cfg.hidden_size), generator=gen)
                for _ in range(2 * steps)]

    def run(model, device):
        cache = make_kv_cache(cfg, b, max_len, device=device)
        ones = torch.ones((b, 1), dtype=torch.bool, device=device)
        h, cache = model(emb.to(device), valid.to(device), pos.to(device),
                         cache)
        outs = [h.float().cpu()]
        for i, x in enumerate(steps_in):
            if i == steps:       # per-row slots, row 1 two further on
                cache['index'] = torch.tensor([s + steps, s + steps + 2],
                                              device=device)
            h, cache = model(x.to(device), ones, (nxt + i).to(device),
                             cache)
            outs.append(h.float().cpu())
        return outs

    with torch.no_grad():
        got = run(llm, 'cuda')
        want = run(copy.deepcopy(llm).to('cpu'), 'cpu')
    del llm
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item() / w.abs().max().item()
        worst = max(worst, err)
        if not (err <= 3e-2 and torch.isfinite(g).all()):
            fail(f'bf16 LLaMA path: call {i} (0 the prefill) differs from '
                 f'the CPU plain path by {err:.3e}')
    print(f'bf16 LLaMA path, full width, 2 layers, B={b}: prefill {s} '
          f'tokens + {steps} scalar-index and {steps} per-row decode steps '
          f'on the card match the CPU plain path within {worst:.3e} x '
          f'max|hidden| (tol 3e-2) [{card}]')


def _answer_problems(np, frames, stats, vocab) -> list:
    """A request's frames and its generator's ``last_stats`` -> what is
    wrong with them."""
    problems = []
    final = frames[-1]
    if any(f['error_code'] != 0 for f in frames):
        problems.append(f'error frame {final}')
    toks = stats['tokens']
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
           for b in final.get('boxes', [])):
        problems.append('malformed boxes in the answer')
    return problems


def _llm_flash_against_dense(torch, model, args):
    """The LLM prefill on one grounded stream (vision with the flash
    kernels), through #4 and through the dense attention -> their largest
    hidden difference over max|hidden| (the dense one's)."""
    from groma_tpu_torch.models.groma import _ordinal
    from groma_tpu_torch.models.llama import make_kv_cache
    dev = model.llm.model.embed_tokens.weight.device
    with torch.inference_mode():
        images, ids, rslot, valid = (torch.as_tensor(a, device=dev)
                                     for a in args)
        emb, _, valid, _ = model.prepare_stream(images.float(), ids.long(),
                                                rslot.long(), valid,
                                                use_flash=True)
        pos = _ordinal(valid).clamp(min=0)
        hidden = [model.llm.model(emb, valid, pos, make_kv_cache(
            model.cfg.llm, 1, emb.shape[1], device=dev), use_flash)[0]
            [valid].float() for use_flash in (True, False)]
    return ((hidden[0] - hidden[1]).abs().max()
            / hidden[1].abs().max()).item()


def serve_unquantized_full_width(torch, np, seed: int, card: str):
    """The default of every JAX entry point, ``--quant_type none``, at full
    width: the port's ModelWorker answers 3 requests through the bf16
    Generator (one sampled), none launching a kernel of the port; one
    prefill through ``Generator(use_flash=True)`` on the same weights
    (exactly 24 launches of #3 and 32 of #4) against the dense prefill; the
    prefill's device time by kernel and a decode token's; then, the model
    freed, the ``--engine`` worker with 4 slots and 4 concurrent requests.
    Returns the flash prefill's (#3, #4) launches."""
    from groma_tpu_torch.eval.generate import Generator
    from groma_tpu_torch.ops.flash_attention import flash_fwd
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.serve.worker import ModelWorker, expand_request

    t0 = time.perf_counter()
    worker = ModelWorker('random', seed=seed, device='cuda')
    cfg = worker.cfg
    gen = worker.generator
    torch.cuda.synchronize()
    up = gen.model.llm.model.layers[0].mlp.up_proj.weight
    if worker.quant_type != 'none' or type(gen) is not Generator \
            or up.dtype != torch.bfloat16:
        fail(f'unquantized path: the default worker serves {worker.quant_type}'
             f' through {type(gen).__name__}, LLM weights in {up.dtype}')
    print(f'unquantized path: random full-width Groma-7B (LLM trunk in '
          f'bf16) built in {time.perf_counter() - t0:.1f} s; device memory '
          f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated')
    vocab = cfg.vocab_size
    flash_fwd.launches.update(bidirectional=0, causal=0)
    int8_matmul.launches = 0
    twin, ptwin = GraphTwin(torch), PrefillTwin(torch)
    for i, prompt in enumerate(SERVED_PROMPTS):
        temperature = UNQUANT_TEMPERATURE if i == 2 else 0.0
        image = random_image(np, seed + 1 + i, cfg.perceiver.image_size)
        warm0 = warmups()
        if i == 0:
            twin.arm('toks')
            ptwin.arm({'_prefill': flip_images})
        try:
            frames = list(worker.generate_stream({
                'image': image, 'prompt': prompt, 'temperature': temperature,
                'max_new_tokens': MAX_NEW_TOKENS}))
        finally:
            twin.disarm()
            ptwin.disarm()
        torch.cuda.synchronize()
        if any(f['error_code'] != 0 for f in frames):
            fail(f'unquantized request {i}: error frame {frames[-1]}')
        stats = gen.last_stats
        problems = _answer_problems(np, frames, stats, vocab)
        warm = warmups() - warm0
        if stats['prefill_mode'] != 'captured' or warm != (i == 0):
            problems.append(f'prefill {stats["prefill_mode"]}, {warm} new '
                            f'prefill graphs (want captured, one at the '
                            f'first request only)')
        if problems:
            fail(f'unquantized request {i}: ' + '; '.join(problems))
        print(f'unquantized request {i} (temperature {temperature}): '
              f'error_code 0, {stats["tokens"].shape[1]} tokens, '
              f'{len(frames[-1]["boxes"])} boxes in the answer, '
              f'{int(stats["selected_mask"].sum())} regions kept; prefill '
              f'(TTFT; a replay'
              f'{WARM_NOTE if warm else ""}'
              f') {stats["prefill_ms"]:.1f} ms, decode '
              f'{stats["decode_ms_per_token"]:.2f} ms/token over '
              f'{stats["decode_forwards"]} forwards (host clock; a new '
              f'graph\'s warm-up step and capture included) [{card}]')
        if i == 0:
            print(ptwin.line('unquantized path (Generator, use_scan=True)',
                             '_prefill', card))
            print(twin.line('unquantized path (Generator, use_scan=True)',
                            card))
    if any(flash_fwd.launches.values()) or int8_matmul.launches:
        fail(f'unquantized path launched a kernel: flash {flash_fwd.launches}'
             f', int8_matmul {int8_matmul.launches}')

    # the same weights, one prefill through the flash kernels
    t = expand_request(worker.tokenizer, worker.spec,
                       {'prompt': SERVED_PROMPTS[0]})
    image = random_image(np, seed + 1, cfg.perceiver.image_size)
    args = (image[None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])
    gen.generate(*args, max_new_tokens=1)
    dense = dict(gen.last_stats)
    flash_gen = Generator(gen.model, max_len=gen.max_len, use_flash=True)
    # its first prefill: warm-up, capture, replay; the twin holds the
    # replay's flash launches to the eager prefill's
    ptwin.arm({'_prefill': flip_images})
    try:
        flash_gen.generate(*args, max_new_tokens=1)
    finally:
        ptwin.disarm()
    torch.cuda.synchronize()
    print(ptwin.line('unquantized path, Generator(use_flash=True)',
                     '_prefill', card))
    per_replay = ptwin.results['_prefill']['delta']
    flash_n = (per_replay.get('flash_fwd.bidirectional', 0),
               per_replay.get('flash_fwd.causal', 0))
    want_n = (cfg.perceiver.vit.num_layers, cfg.llm.num_layers)
    fl = flash_gen.last_stats
    err = np.abs(fl['first_logits'] - dense['first_logits']).max() \
        / np.abs(dense['first_logits']).max()
    kept = (int(fl['selected_mask'].sum()), int(dense['selected_mask'].sum()))
    in_place = float(np.mean(np.abs(fl['selected_boxes']
                                    - dense['selected_boxes']).max(-1)
                             < 1e-2))
    llm_err = _llm_flash_against_dense(torch, gen.model, args)
    if flash_n != want_n or not (err <= UNQUANT_FLASH_TOL
                                 and kept[0] == kept[1]
                                 and llm_err <= UNQUANT_LLM_FLASH_TOL):
        fail(f'Generator(use_flash=True) prefill: flash launches {flash_n} '
             f'(want {want_n}), first logits {err:.3e} x max|logits| from '
             f'the dense prefill (tol {UNQUANT_FLASH_TOL}), regions kept '
             f'{kept}, the LLM alone {llm_err:.3e} x max|hidden| (tol '
             f'{UNQUANT_LLM_FLASH_TOL})')
    print(f'Generator(use_flash=True) prefill: {flash_n[0]} launches of '
          f'flash_fwd (bidirectional, the ViT) and {flash_n[1]} (causal, the '
          f'LLM at S = {cfg.max_seq_len}) a replay; its first logits within '
          f'{err:.3e} x max|logits| of the dense prefill (tol '
          f'{UNQUANT_FLASH_TOL}; {kept[0]} regions kept by both, '
          f'{in_place:.0%} of the pool\'s slots holding the same box); the '
          f'LLM alone on the flash stream, flash against dense, within '
          f'{llm_err:.3e} x max|hidden| (tol {UNQUANT_LLM_FLASH_TOL}); host '
          f'{fl["prefill_ms"]:.1f} ms (the first call: warm-up, capture, '
          f'replay and the twin) against the dense replay\'s '
          f'{dense["prefill_ms"]:.1f} [{card}]')

    # device time: a prefill alone, dense and flash, then the dense
    # request with 9 tokens; the difference is the decode's
    pre = {}
    for name, g in (('use_flash', flash_gen), ('dense', gen)):
        worker.generator = g
        pre[name] = served_device_profile(torch, worker, image,
                                          SERVED_PROMPTS[0], 1)
        stats, ms, by_name = pre[name]
        top = ', '.join(f'{k[:56]} {v:.2f}' for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8])
        print(f'unquantized path ({name}), warm prefill '
              f'({stats["prefill_mode"]}) under torch.profiler: host '
              f'{stats["prefill_ms"]:.1f} ms, {ms:.2f} ms of device time '
              f'(host / device {stats["prefill_ms"] / ms:.3f}); the longest '
              f'kernels, ms: {top} [{card}]')
    dec_stats, dec_ms, dec_names = served_device_profile(
        torch, worker, image, SERVED_PROMPTS[0], 9)
    _, pre_ms, pre_names = pre['dense']
    fwd = dec_stats['decode_forwards']
    if fwd:
        diff = {k: (v - pre_names.get(k, 0.0)) / fwd
                for k, v in dec_names.items()}
        top = ', '.join(f'{k[:48]} {v:.3f}' for k, v in sorted(
            diff.items(), key=lambda kv: -kv[1])[:5])
        print(f'unquantized path, the same request with 9 new tokens: '
              f'{(dec_ms - pre_ms) / fwd:.3f} ms of device time a decode '
              f'token ({fwd} forwards; host '
              f'{dec_stats["decode_ms_per_token"]:.2f} ms/token); the '
              f'longest kernels, ms a token: {top} [{card}]')
    else:
        print(f'unquantized path: no decode forward ran (an early end of '
              f'sequence), device time a token not measured [{card}]')
    # free the model (every name that holds it) before the engine builds
    # its own
    del worker, gen, flash_gen, g
    gc.collect()
    torch.cuda.empty_cache()

    # the --engine worker with qp=None: 4 requests at once over 4 slots
    t0 = time.perf_counter()
    worker = ModelWorker('random', seed=seed, device='cuda', use_engine=True,
                         engine_slots=UNQUANT_ENGINE_SLOTS)
    engine = worker.engine
    if engine.qp is not None:
        fail('unquantized engine: the worker built a quantized tree')
    print(f'unquantized engine: {UNQUANT_ENGINE_SLOTS} slots, max_len '
          f'{engine.max_len}, built in {time.perf_counter() - t0:.1f} s; '
          f'device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB '
          f'[{card}]')
    results = [None] * UNQUANT_ENGINE_SLOTS

    def client(i):
        frames = list(worker.generate_stream({
            'image': random_image(np, seed + 20 + i,
                                  cfg.perceiver.image_size),
            'prompt': SERVED_PROMPTS[i % len(SERVED_PROMPTS)],
            'max_new_tokens': ENGINE_MAX_NEW, 'stream_chunk': 1}))
        results[i] = frames
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(UNQUANT_ENGINE_SLOTS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    st = engine.stats()
    bad = [i for i, r in enumerate(results)
           if r is None or any(f['error_code'] != 0 for f in r)
           or 'boxes' not in r[-1]]
    if bad or st['finished'] != UNQUANT_ENGINE_SLOTS \
            or st['nonfinite_logits'] or st['prefill_mode'] != 'captured':
        fail(f'unquantized engine: requests {bad} failed; finished '
             f'{st["finished"]} of {UNQUANT_ENGINE_SLOTS}, '
             f'{st["nonfinite_logits"]} with non-finite logits, prefill '
             f'{st["prefill_mode"]}')
    tokens = st['tokens_emitted']
    print(f'unquantized engine: {UNQUANT_ENGINE_SLOTS} concurrent requests '
          f'finished in {wall:.2f} s: {tokens} tokens, {tokens / wall:.1f} '
          f'tok/s aggregate, mean TTFT {st["mean_ttft_sec"] * 1e3:.1f} ms '
          f'(engine clock), {st["decode_steps"]} decode steps at '
          f'{st["decode_ms_per_step"]:.2f} ms/step [{card}]')
    engine_twin(torch, np, worker, seed + 30, 'unquantized engine (qp=None)',
                card)
    engine.close()
    del worker, engine
    return flash_n


def engine_twin(torch, np, worker, seed: int, name: str, card: str):
    """One more request through a warm engine, its prefill checked against
    the eager prefill (PrefillTwin) and its first burst against the eager
    step (GraphTwin) after the timed run."""
    twin, ptwin = GraphTwin(torch), PrefillTwin(torch)
    twin.arm('out')
    ptwin.arm({'_prefill_one': flip_images})
    warm0 = warmups()
    try:
        frames = list(worker.generate_stream({
            'image': random_image(np, seed, worker.cfg.perceiver.image_size),
            'prompt': SERVED_PROMPTS[0], 'max_new_tokens': ENGINE_MAX_NEW,
            'stream_chunk': 1}))
    finally:
        twin.disarm()
        ptwin.disarm()
    if any(f['error_code'] != 0 for f in frames):
        fail(f'{name}: error frame {frames[-1]}')
    if warmups() != warm0:
        fail(f'{name}: a warm engine captured a new prefill graph')
    print(ptwin.line(name, '_prefill_one', card))
    print(twin.line(f'{name}, one burst', card))


def serve_engine_full_width(torch, np, seed: int, card: str):
    """The production server, ``--engine --engine-slots 8 --quant_type int4
    --kv-bits 8 --paged-kv``, at full width: ENGINE_REQUESTS requests from
    as many threads at once through the port's ModelWorker.  Returns the
    int4 and paged kernels' launches."""
    import threading
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
    prefill, prefill_ms = engine._prefill, []

    def timed_prefill(reqs):
        # host clock: the prefill ends by copying positions to the host
        t = time.perf_counter()
        out = prefill(reqs)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out
    engine._prefill = timed_prefill

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

    zero_counts()
    threads = [threading.Thread(target=client, args=(i,), name=f'client{i}')
               for i in range(ENGINE_REQUESTS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    ran = device_launches()
    mm, att = ran['int4_matmul'], ran['paged_int8_decode_attention']
    mm_prefill = ran['int4_matmul.prefill']
    engine._prefill = prefill
    st = engine.stats()
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
    # a new prefill graph's warm-up runs the prefill once more
    warm = warmups()
    want_mm = (ENGINE_REQUESTS + steps + warm) * (4 * n_layers + 1)
    problems = []
    if st['prefill_mode'] != 'captured' or warm != 1:
        problems.append(f'prefill {st["prefill_mode"]}, {warm} prefill '
                        f'graphs captured (want one, b = 1)')
    if st['finished'] != ENGINE_REQUESTS or st['truncated'] != 0:
        problems.append(f'finished {st["finished"]}, truncated '
                        f'{st["truncated"]}')
    if st['free_pages'] != st['total_pages']:
        problems.append(f'{st["total_pages"] - st["free_pages"]} pages not '
                        f'returned')
    if st['nonfinite_logits']:
        problems.append(f'{st["nonfinite_logits"]} prefills or bursts with '
                        f'non-finite logits')
    # every prompt is packed into the fixed max_seq_len layout, so each
    # prefill runs its 4 L layer matmuls at M = 2048 (the prefill tile)
    want_prefill = (ENGINE_REQUESTS + warm) * 4 * n_layers
    if att % n_layers or steps != st['decode_steps'] or mm != want_mm \
            or mm_prefill != want_prefill:
        problems.append(f'launches int4_matmul {mm} (want {want_mm} = '
                        f'({ENGINE_REQUESTS} prefills + {warm} warm-up + '
                        f'{steps} steps) x '
                        f'{4 * n_layers + 1}), of them the prefill tile\'s '
                        f'{mm_prefill} (want {want_prefill}), paged attention '
                        f'{att} (want a multiple of {n_layers}, '
                        f'{st["decode_steps"]} steps)')
    if problems:
        fail('engine: ' + '; '.join(problems))
    print(f'engine: {ENGINE_REQUESTS} requests through {st["max_slots"]} '
          f'slots in {wall:.2f} s: {tokens} tokens, {tokens / wall:.1f} tok/s '
          f'aggregate, mean TTFT {st["mean_ttft_sec"] * 1e3:.1f} ms (engine '
          f'clock), {st["decode_steps"]} decode steps at '
          f'{st["decode_ms_per_step"]:.2f} ms/step (each step one token for '
          f'every live slot); every page returned; launches int4_matmul {mm} '
          f'(the prefill tile {mm_prefill}; {warm} prefill graph warm-up), '
          f'paged attention {att} [{card}]')
    pm = sorted(prefill_ms[1:])
    print(f'engine: {len(prefill_ms)} prefills (vision, surgery, the LLM at '
          f'M = {cfg.max_seq_len}, first logits; host clock, the replay and '
          f'the read of next positions), ms: the first (warm-up, capture, '
          f'replay) {prefill_ms[0]:.1f}, the replays: median '
          f'{pm[len(pm) // 2]:.1f}, min {pm[0]:.1f}, max {pm[-1]:.1f} '
          f'[{card}]')
    engine_device_per_step(torch, np, worker, card)
    engine_twin(torch, np, worker, seed + 40,
                'engine (int4 + paged kv8, 8 slots)', card)
    engine.close()
    del worker, engine
    return mm, att, mm_prefill


# the serving stack (phase 7b): JAX's REC engine cell (bench_engine.py)
STACK_SLOTS, STACK_BURST, STACK_CHUNK = 8, 24, 192
STACK_STREAM, STACK_MAX_NEW, STACK_REQUESTS = 640, 48, 16
STACK_LOOKAHEAD = 4        # --spec-lookahead: the verify step's G
STACK_COSINE_MIN = 0.99    # chunked first logits against the one-shot's
# the chunked engine against the one-shot engine, on the logits each
# picked its tokens from: the first logits' largest difference relative to
# max|one-shot|, and a later token's (while the streams agree) absolute.
# On an H100 at --seed 0 this phase read at most 0.0236 and 0.113 alone,
# 0.0254 and 0.111 in the whole script (16 requests, about 300 later
# tokens); benchmarks/chunk_divergence.py at b=1 (4 requests) sound 0.0231
# and 0.109, with chunks 2-4 at rope positions one too far 0.0272 to
# 0.0328 and 0.164 to 0.191, one slot late 0.0233 and 0.125, one slot
# early 0.0256 and 0.117 (a single key moved or lost: with random weights
# no bound tells that from sound)
STACK_FIRST_REL_MAX = 0.03
STACK_CHUNK_DIFF_MAX = 0.14
STACK_LOGIT_STEPS = 1024   # decode steps a drive's recorder keeps
# the verify's dequantized key and value writes past layer 0 against the
# sequential decode's, relative to max|sequential| (their inputs went
# through the dequantized-cache attention and the int8 decode kernel)
STACK_VERIFY_KV_TOL = 0.25
STACK_PROMPT = 'Locate the {} red object on the left of the image.'
STACK_ORDINALS = ('first', 'second', 'third', 'fourth', 'fifth', 'sixth',
                  'seventh', 'eighth', 'ninth', 'tenth', 'eleventh',
                  'twelfth', 'thirteenth', 'fourteenth', 'fifteenth',
                  'sixteenth')


def _png_bytes(img) -> bytes:
    """An RGB uint8 (H, W, 3) image as a PNG of unfiltered rows."""
    import struct
    import zlib
    h, w, _ = img.shape
    raw = b''.join(b'\x00' + img[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def _post(url: str, payload: dict, timeout: float = 600) -> bytes:
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _http_server(handler):
    """A local HTTP server on a free port, served from a daemon thread ->
    (server, its URL)."""
    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f'http://127.0.0.1:{httpd.server_address[1]}'


def _worst_stall(stamps) -> float:
    """bench_engine.py's measure: the longest gap between two bursts that
    a live stream sees (a burst's tokens arrive within 2 ms), its own first
    token's wait left out; seconds."""
    worst = 0.0
    for v in stamps:
        bursts = [t for a, t in zip(v[1:], v[2:]) if t - a > 2e-3]
        for a, b in zip([v[1]] + bursts, bursts):
            worst = max(worst, b - a)
    return worst


def _load_state(dst, src):
    """Copy the tensors of ``src`` into those of ``dst`` under the same
    keys (``dst`` may hold more)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _load_state(dst[k], v)
        elif isinstance(v, list):
            for d, s in zip(dst[k], v):
                d.copy_(s)
        elif hasattr(v, 'copy_'):
            dst[k].copy_(v)


def _record_steps(torch, engine) -> LogitRecorder:
    """Keep the logits of every decode step of ``engine``: its step's
    ``_pick`` wrapped before any burst is captured, STACK_LOGIT_STEPS
    steps of (slots, vocabulary) logits."""
    rec = LogitRecorder(torch, STACK_LOGIT_STEPS)
    record, pick = rec.record, engine._pick

    def recording_pick(logits, temps, sample):
        record(logits)
        return pick(logits, temps, sample)
    engine._pick = recording_pick
    return rec


def _stack_drive(torch, np, engine, rec, requests, chunked: bool):
    """``requests`` submitted at once in-process, each stream consumed on
    its own thread (bench_engine.py's drive) -> the run's record: sessions,
    token arrival times, wall seconds, device launches, decode steps and
    their seconds, chunk steps, each request's first logits and seated
    cache index, and the logits each of its tokens was picked from
    (``logits(i, t)``: token 0 from the prefill's, token t from decode
    step seat + t - 1 of its slot, as ``rec`` recorded it)."""
    seat, first = engine._seat, {}
    steps0, sec0 = engine._n_steps, engine._decode_sec

    def recording_seat(slot, sess, row_logits, one, row, vis, next_pos):
        # row_logits: the (vocabulary,) first logits
        first[id(sess)] = (row_logits.float().cpu(), int(one['index']),
                           slot, engine._n_steps - steps0)
        return seat(slot, sess, row_logits, one, row, vis, next_pos)
    engine._seat = recording_seat
    chunks = []
    graph = engine._chunk
    if chunked:
        run = graph.run

        def counted_run(n):
            chunks.append(n)
            return run(n)
        graph.run = counted_run
    stamps = [[] for _ in requests]
    torch.cuda.synchronize()
    rec.reset()
    zero_counts()
    t0 = time.perf_counter()
    sessions = [engine.submit(*r, max_new_tokens=STACK_MAX_NEW)
                for r in requests]

    def consume(i):
        for _ in sessions[i].token_stream():
            stamps[i].append(time.perf_counter())
    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = device_launches()
    if warmups():
        fail(f'serving stack: the warm {"chunked" if chunked else "one-shot"}'
             f' engine captured {warmups()} new prefill graphs')
    del engine._seat
    if chunked:
        del graph.run
    if any(th.is_alive() for th in threads) \
            or any(s.error for s in sessions):
        fail(f'serving stack: a request of the '
             f'{"chunked" if chunked else "one-shot"} engine did not finish')
    seated = [first[id(s)] for s in sessions]

    def logits(i, t):
        lg, _, slot, step = seated[i]
        return lg if t == 0 else rec.row(step + t - 1)[slot].float().cpu()
    return {'sessions': sessions, 'stamps': stamps, 'wall': wall,
            'ran': ran, 'steps': engine._n_steps - steps0,
            'decode_sec': engine._decode_sec - sec0, 'chunks': sum(chunks),
            'first': [(lg, index) for lg, index, _, _ in seated],
            'logits': logits}


def _chunked_against_one_shot(torch, np, chk, one, n: int, card: str):
    """Each request's chunked stream against its one-shot stream, on the
    logits each engine picked its tokens from: at every token up to the
    first that parts, each engine's token a maximum of its own logits
    (ties counted); the first logits within STACK_FIRST_REL_MAX of
    max|one-shot| and a cosine of at least STACK_COSINE_MIN, every later
    token's logits within STACK_CHUNK_DIFF_MAX; where the tokens part, a
    near-tie (``_parted_at_near_tie``, at the position's bound)."""
    cosines, rels, diffs, parted, problems = [], [], [], [], []
    for i in range(n):
        x, y = chk['sessions'][i].tokens, one['sessions'][i].tokens
        j = _first_difference(x, y)
        for t in range(min(j + 1, len(x), len(y))):
            got, ref = chk['logits'](i, t), one['logits'](i, t)
            if not (_is_max(got, x[t]) and _is_max(ref, y[t])):
                problems.append(f'request {i} token {t}: a token is not the '
                                f'maximum of its own recorded logits')
            scale = 1.0
            if t == 0:
                cosines.append(_cosine(np, got.numpy(), ref.numpy()))
                scale = ref.abs().max().item()
                bound = STACK_FIRST_REL_MAX * scale
            else:
                bound = STACK_CHUNK_DIFF_MAX
            d = (got - ref).abs().max().item()
            (rels if t == 0 else diffs).append(d / scale)
            if d > bound:
                problems.append(f'request {i} token {t}: |chunked - '
                                f'one-shot| {d / scale:.4e}'
                                f'{" of max|one-shot|" if t == 0 else ""}')
            if t == j:
                gap, _, tie = _parted_at_near_tie(ref, got, y[t], x[t],
                                                  bound)
                kind = 'a near-tie' if tie else 'NOT a near-tie'
                parted.append(f'request {i} at token {t} ({x[t]} against '
                              f'{y[t]}: gap {gap:.4e}, |chunked - one-shot| '
                              f'{d:.4e}, {kind})')
                if not tie:
                    problems.append(f'request {i} parts at token {t} where '
                                    f'the logits are not near a tie')
    diffs = sorted(diffs) or [0.0]
    print(f'serving stack, chunked against one-shot, on the logits each '
          f'engine picked its tokens from (recorded in its captured step): '
          f'first logits cosine min {min(cosines):.6f} (at least '
          f'{STACK_COSINE_MIN}), |chunked - one-shot| at most '
          f'{max(rels):.4e} of max|one-shot| (median '
          f'{sorted(rels)[n // 2]:.4e}; at most {STACK_FIRST_REL_MAX}); '
          f'{len(diffs)} later tokens up to the first parted one: |chunked '
          f'- one-shot| at most {diffs[-1]:.4e}, median '
          f'{diffs[len(diffs) // 2]:.4e} (at most {STACK_CHUNK_DIFF_MAX}); '
          f'tokens equal in {n - len(parted)} of {n} requests'
          + (f', first different {"; ".join(parted)}' if parted else '')
          + f' [{card}]')
    if min(cosines) < STACK_COSINE_MIN:
        problems.append('chunked first logits too far from the one-shot')
    if problems:
        fail('serving stack, chunked against one-shot: '
             + '; '.join(problems))


def chunk_step_twin(torch, engine, args, card: str):
    """One request's chunked prefill, chunk by chunk, through the engine's
    captured chunk step (replays) and eagerly on a copy of its state: the
    hidden states and the chunk cache bitwise equal after every chunk;
    host ms a chunk of each; the launches of a replay."""
    from groma_tpu_torch.models.groma import _ordinal
    from groma_tpu_torch.utils.graphs import launch_counts
    graph = engine._chunk
    on_card = graph.device.type == 'cuda'
    if on_card and graph.graph is None:
        fail('serving stack: the chunk step was never captured')
    st, c = graph.state, engine.prefill_chunk_tokens
    dev = engine.device
    with torch.inference_mode():
        image, ids, slot, valid0 = (torch.as_tensor(a[None], device=dev)
                                    for a in args)
        emb, _, valid, _ = engine.model.prepare_stream(
            image.float(), ids.long(), slot.long(), valid0)
        pos = _ordinal(valid).clamp(min=0)
        n = int(valid[0].nonzero()[-1]) // c + 1
        pad = max(n * c - emb.shape[1], 0)
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        pos = torch.nn.functional.pad(pos, (0, pad))
        st['cache']['mask'].zero_()
        st['cache']['index'].zero_()
        copy = _clone_tree(torch, st)
        same, eager_ms, replay_ms = True, 0.0, 0.0
        for ci in range(n):
            for state in (st, copy):
                state['emb'].copy_(emb[:, ci * c:ci * c + c])
                state['valid'].copy_(valid[:, ci * c:ci * c + c])
                state['pos'].copy_(pos[:, ci * c:ci * c + c])
            counts = launch_counts()
            eager_ms += _timed(torch, lambda: graph.step(copy), 1)
            set_launch_counts(counts)           # comparison launches
            replay_ms += _timed(torch, lambda: graph.run(1), 1)
            same = same and torch.equal(st['hidden'], copy['hidden'])
        same = same and all(torch.equal(a, b) for a, b in zip(
            _state_tensors(st['cache']), _state_tensors(copy['cache'])))
    want = {'int8_matmul': 4 * engine.cfg.llm.num_layers}
    print(f'serving stack, the chunk step ({n} chunks of {c} of one request, '
          f'graph against eager on a copy of its state): hidden states and '
          f'chunk cache {"bitwise equal" if same else "DIFFER"}; '
          f'{replay_ms / n:.3f} against {eager_ms / n:.3f} ms a chunk (host '
          f'clock, synchronized); a replay launches {graph.delta} (want '
          f'{want}) [{card}]')
    if not same or (on_card and graph.delta != want):
        fail('serving stack: the chunk step\'s replays differ from the eager '
             'step, or its launches from the decode tile\'s 4 L')


def _state_tensors(tree):
    from groma_tpu_torch.utils.graphs import _tensors
    return list(_tensors(tree))


def verify_on_live_state(torch, np, engine, snap, card: str):
    """The engine's verify step (JAX's verify_chunk) on copies of its live
    decode state ``snap`` (all slots live, taken after a burst): drafts =
    each row's next G sequential greedy tokens (teacher-forced, from the
    decode step on a copy).  Rows whose sequential logits have no near-tie
    (every top-2 gap at least SPEC_LOGIT_DIFF_MAX) accept all G; a row
    parts only where its gap is below that; the cache slots written up to
    ``keep`` are within one int8 unit of the sequential decode's writes and
    the mask is False past ``keep``; every row that accepted its first
    draft, given a second draft its verify did not pick, keeps its first
    draft only, and the others verify as before; a finished row changes
    nothing; the captured verify's replay is bitwise the eager step."""
    import groma_tpu_torch.serve.engine as engine_mod
    from groma_tpu_torch.utils.graphs import launch_counts
    G, nb = engine.spec_lookahead, engine.max_slots
    n_layers = engine.cfg.llm.num_layers
    with torch.inference_mode():
        # the sequential decode on a copy: G + 1 tokens, their top-2 gaps
        seq = _clone_tree(torch, snap)
        seq['step'].zero_()
        gaps, logits_fn = [], engine_mod.quant_logits

        def recording(qp, hidden):
            out = logits_fn(qp, hidden)
            top2 = torch.topk(out[:, -1].float(), 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            return out
        engine_mod.quant_logits = recording
        try:
            counts0 = launch_counts()
            for _ in range(G + 1):
                engine._step(seq, False)
            set_launch_counts(counts0)          # comparison launches
        finally:
            engine_mod.quant_logits = logits_fn
        want = seq['out'][:, :G + 1].cpu().numpy()
        gap = np.stack(gaps, 1)           # (B, G + 1)
        drafts = want[:, :G].copy()
        index0 = snap['cache']['index'].cpu().numpy()
        state = _clone_tree(torch, snap)
        verify = engine.verifier(state)

        def run(src, d):
            _load_state(state, src)
            emitted, counts = verify(d)
            return emitted, counts, _clone_tree(torch, state)
        eager = run(snap, drafts)         # the warm-up step, eager
        replay = run(snap, drafts)        # captured, then replayed
        same = (np.array_equal(eager[0], replay[0])
                and np.array_equal(eager[1], replay[1])
                and all(torch.equal(a, b) for a, b in zip(
                    _state_tensors(eager[2]), _state_tensors(replay[2]))))
        emitted, counts, after = replay
        problems = []
        full = [r for r in range(nb) if gap[r].min() >= SPEC_LOGIT_DIFF_MAX]
        kv_rel = 0.0
        for r in range(nb):
            k = int(counts[r])
            if r in full and (k != G + 1 or list(emitted[r]) != list(want[r])):
                problems.append(f'row {r} (no near-tie) accepted {k - 1}')
            elif k < G + 1 and (
                    list(emitted[r, :k - 1]) != list(want[r, :k - 1])
                    or gap[r, k - 1] >= SPEC_LOGIT_DIFF_MAX):
                problems.append(f'row {r} parted at {k - 1} without a '
                                f'near-tie (gap {gap[r, k - 1]:.4f})')
            keep = index0[r] + k
            mask = after['cache']['mask'][r]
            if bool(mask[keep:].any()):
                problems.append(f'row {r}: mask set past keep')
            w = slice(index0[r], keep)
            for key in ('k', 'v'):
                # layer 0 sees the same inputs: one int8 unit at most; a
                # deeper layer's input went through the two attentions
                d = (after['cache'][key][0][r, :, w].int()
                     - seq['cache'][key][0][r, :, w].int())
                if d.abs().max().item() > 1:
                    problems.append(f'row {r}: layer 0 {key} more than one '
                                    f'int8 unit from the sequential '
                                    f'decode\'s')
                for lay in range(1, n_layers):
                    got = (after['cache'][key][lay][r, :, w].float()
                           * after['cache'][key + '_scale'][lay][
                               r, :, w, None])
                    ref = (seq['cache'][key][lay][r, :, w].float()
                           * seq['cache'][key + '_scale'][lay][r, :, w, None])
                    rel = ((got - ref).abs().max()
                           / ref.abs().max()).item()
                    kv_rel = max(kv_rel, rel)
        # every row that accepted its first draft given a wrong second one
        # (one its verify did not pick): it keeps its first draft only,
        # near-ties or not; the other rows verify as before
        wrong = drafts.copy()
        planted = [r for r in range(nb) if counts[r] >= 2]
        for r in planted:
            wrong[r, 1] = (emitted[r, 1] + 1) % engine.cfg.vocab_size
        _, w_counts, w_after = run(snap, wrong)
        w_index = w_after['cache']['index'].cpu().numpy()
        if not planted:
            problems.append('no row accepted its first draft')
        for r in range(nb):
            k = min(int(counts[r]), 2)
            if (w_counts[r] != k or w_index[r] != index0[r] + k
                    or bool(w_after['cache']['mask'][
                        r, index0[r] + k:].any())):
                problems.append(f'the wrong second draft of row {r}: counts '
                                f'{w_counts[r]}, index {w_index[r]} (from '
                                f'{index0[r]}, want {k} and '
                                f'{index0[r] + k})')
        # a finished row changes nothing
        r1 = nb - 1
        frozen = _clone_tree(torch, snap)
        frozen['done'][r1] = True
        f_emitted, f_counts, f_after = run(frozen, drafts)
        unchanged = (f_counts[r1] == 0
                     and (f_emitted[r1] == engine.eos_id).all()
                     and all(torch.equal(f_after[k][r1], frozen[k][r1])
                             for k in ('tok', 'pos', 'done'))
                     and torch.equal(f_after['cache']['mask'][r1],
                                     frozen['cache']['mask'][r1])
                     and int(f_after['cache']['index'][r1]) == index0[r1]
                     and all(torch.equal(
                         f_after['cache'][key][lay][r1, :, :index0[r1]],
                         frozen['cache'][key][lay][r1, :, :index0[r1]])
                         for key in ('k', 'v') for lay in range(n_layers)))
        if not unchanged:
            problems.append(f'the finished row {r1} changed')
        if kv_rel > STACK_VERIFY_KV_TOL:
            problems.append(f'written keys and values of layers 1 on '
                            f'{kv_rel:.3e} of max|sequential| apart')
    delta = verify.graph.delta
    want_delta = ({'int8_matmul': 4 * n_layers + 1}
                  if verify.graph.device.type == 'cuda' else {})
    print(f'serving stack, the verify step on the engine\'s live state (B = '
          f'{nb}, G = {G}, drafts the next G sequential greedy tokens): '
          f'counts {counts.tolist()} (rows with no near-tie, every '
          f'sequential top-2 gap >= {SPEC_LOGIT_DIFF_MAX}: {full}); the '
          f'smallest gap of each row '
          f'{[round(float(g), 4) for g in gap.min(1)]}; '
          f'written slots up to keep: layer 0 within one int8 unit of the '
          f'sequential decode\'s, layers 1 on within {kv_rel:.3e} of '
          f'max|sequential| (at most {STACK_VERIFY_KV_TOL}), the mask False '
          f'past keep; a wrong second draft on rows {planted} (those that '
          f'accepted their first): counts {w_counts.tolist()}; '
          f'finished row {r1}: counts {int(f_counts[r1])}, its state '
          f'{"unchanged" if unchanged else "CHANGED"}; replay against the '
          f'eager step {"bitwise equal" if same else "DIFFER"}; a replay '
          f'launches {delta} (want {want_delta}) [{card}]')
    if problems or not same or delta != want_delta:
        fail('serving stack, verify step: ' + '; '.join(
            problems + ([] if same else ['replay differs from eager'])
            + ([] if delta == want_delta else [f'launches {delta}'])))


def serve_stack_full_width(torch, np, seed: int, card: str):
    """Phase 7b: the serving stack at full width on JAX's REC engine cell
    (benchmarks/bench_engine.py: 8 slots, bursts of 24, prefill chunks of
    192, a 640-slot REC stream, 48 new tokens), int8 LLM, int8 KV.
    Returns the chunked run's launches of #1 and #2."""
    import base64

    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.image_pipeline import normalize, resize
    from groma_tpu_torch.serve import controller as t_controller
    from groma_tpu_torch.serve import web as t_web
    from groma_tpu_torch.serve.engine import BatchEngine
    from groma_tpu_torch.serve.worker import (ModelWorker, expand_request,
                                              make_handler)
    t0 = time.perf_counter()
    # the worker as `--engine --engine-slots 8 --quant_type int8 --kv-bits 8
    # --prefill-chunk 192 --spec-lookahead 4` starts it
    worker = ModelWorker('random', seed=seed, quant_type='int8', kv_bits=8,
                         device='cuda', use_engine=True,
                         engine_slots=STACK_SLOTS, prefill_chunk=STACK_CHUNK,
                         spec_lookahead=STACK_LOOKAHEAD)
    engine = worker.engine
    flags = (engine.prefill_chunk_tokens, engine.spec_lookahead)
    engine.close()
    model, qp, cfg = engine.model, engine.qp, worker.cfg
    del engine
    worker.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    if flags != (STACK_CHUNK, STACK_LOOKAHEAD):
        fail(f'serving stack: the worker\'s flags reached its engine as '
             f'{flags}')
    # JAX's REC cell: a 640-slot stream, bursts of 24, 48 new tokens, no
    # EOS (every request decodes all 48), max_len 768, the flag's chunk;
    # the lookahead only on the engine whose state the verify takes
    kw = dict(max_slots=STACK_SLOTS,
              max_len=STACK_STREAM + STACK_MAX_NEW + 8, eos_id=-1,
              chunk=STACK_BURST, max_new_tokens=STACK_MAX_NEW, kv_bits=8)
    chunked = BatchEngine(model, qp, prefill_chunk_tokens=STACK_CHUNK, **kw)
    chk_rec = _record_steps(torch, chunked)
    worker.engine = chunked
    worker.spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                             max_region_num=cfg.max_region_num,
                             max_seq_len=STACK_STREAM,
                             image_size=cfg.perceiver.image_size)
    size = cfg.perceiver.image_size
    rng = np.random.default_rng(seed + 60)
    pixels = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(STACK_REQUESTS)]
    prompts = [STACK_PROMPT.format(o) for o in STACK_ORDINALS]
    # each request as the worker builds it (the web front's PNG decode and
    # 448² resize for the first)
    images = [normalize(resize(t_web.decode_png(_png_bytes(pixels[0])),
                               (448, 448))[0])]
    images += [normalize(p) for p in pixels[1:]]
    expanded = [expand_request(worker.tokenizer, worker.spec, {'prompt': p})
                for p in prompts]
    requests = [(img, t['input_ids'], t['region_slot'], t['valid'])
                for img, t in zip(images, expanded)]
    print(f'serving stack: random full-width Groma-7B, int8 LLM and KV, '
          f'{STACK_SLOTS} slots, bursts of {STACK_BURST}, prefill chunks of '
          f'{STACK_CHUNK}, {STACK_STREAM}-slot REC streams, '
          f'{STACK_MAX_NEW} new tokens (max_len {chunked.max_len}; the '
          f'verify\'s engine alone takes lookahead {STACK_LOOKAHEAD}); built '
          f'in '
          f'{time.perf_counter() - t0:.1f} s; device memory '
          f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]')

    # 1. over HTTP: the controller, the worker registered by heartbeat, one
    # request through the web front, the rest dispatched by the controller
    controller = t_controller.Controller('shortest_queue')
    servers = []
    try:
        c_httpd, c_url = _http_server(t_controller.make_handler(controller))
        servers.append(c_httpd)
        w_httpd, w_url = _http_server(make_handler(worker))
        servers.append(w_httpd)
        web_httpd, web_url = _http_server(t_web.make_handler(c_url, 'groma'))
        servers.append(web_httpd)
        worker.worker_name, worker.controller_addr = w_url, c_url
        worker._register()
        beat = worker._post('/receive_heart_beat', {
            'worker_name': w_url, 'queue_length': 0})
        if not beat.get('exist') or controller.list_models() != ['groma']:
            fail('serving stack: the worker did not register')
        sessions = {}
        submit = chunked.submit

        def recording_submit(*a, **k):
            sess = submit(*a, **k)
            sessions[np.asarray(a[1]).tobytes()] = sess
            return sess
        chunked.submit = recording_submit
        finals = [None] * STACK_REQUESTS

        def client(i):
            if i == 0:
                finals[i] = json.loads(_post(web_url + '/chat', {
                    'image_b64': base64.b64encode(
                        _png_bytes(pixels[0])).decode(),
                    'prompt': prompts[0],
                    'max_new_tokens': STACK_MAX_NEW}))
                return
            addr = json.loads(_post(c_url + '/get_worker_address',
                                    {'model': 'groma'}))['address']
            body = _post(addr + '/worker_generate_stream', {
                'image': images[i].tolist(), 'prompt': prompts[i],
                'max_new_tokens': STACK_MAX_NEW,
                'stream_chunk': STACK_MAX_NEW})
            finals[i] = [json.loads(x) for x in body.decode().split('\0')
                         if x.strip()][-1]
        t_http = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(STACK_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_http = time.perf_counter() - t_http
        del chunked.submit
    finally:
        for httpd in servers:
            httpd.shutdown()
    vocab = cfg.vocab_size
    http_tokens = []
    for i, final in enumerate(finals):
        sess = sessions.get(np.asarray(requests[i][1]).tobytes())
        problems = []
        if final is None or sess is None:
            fail(f'serving stack: request {i} did not finish over HTTP')
        if final.get('error_code') != 0 or 'boxes' not in final:
            problems.append(f'final frame {str(final)[:200]}')
        toks = np.asarray(sess.tokens)
        if len(toks) != STACK_MAX_NEW or not ((toks >= 0)
                                              & (toks < vocab)).all():
            problems.append(f'{len(toks)} tokens, or out of the vocabulary')
        boxes, mask = sess.vis['selected_boxes'], sess.vis['selected_mask']
        if not mask.any() or not np.isfinite(boxes).all():
            problems.append('malformed selected boxes')
        if problems:
            fail(f'serving stack, request {i} over HTTP: '
                 + '; '.join(problems))
        http_tokens.append(toks.tolist())
    print(f'serving stack over HTTP: {STACK_REQUESTS} requests (1 through the '
          f'web front, {STACK_REQUESTS - 1} dispatched by the controller, '
          f'from as many threads) finished in {t_http:.2f} s, each '
          f'{STACK_MAX_NEW} tokens in the vocabulary, boxes finite; the '
          f'controller counted {controller.workers[w_url].queue_length} '
          f'dispatches [{card}]')

    # 2-5. the same requests in-process: the one-shot engine, then the
    # chunked one (warm from the HTTP run), each run's launches exact
    oneshot = BatchEngine(model, qp, **kw)
    one_rec = _record_steps(torch, oneshot)
    ptwin = PrefillTwin(torch)
    try:
        # the warm request: prefill_one's capture, checked against its
        # eager twin
        ptwin.arm({'_prefill_one': flip_images})
        try:
            warm = oneshot.submit(*requests[0], max_new_tokens=STACK_MAX_NEW)
            list(warm.token_stream())
        finally:
            ptwin.disarm()
        print(ptwin.line('serving stack, one-shot engine', '_prefill_one',
                         card))
        one = _stack_drive(torch, np, oneshot, one_rec, requests,
                           chunked=False)
    finally:
        oneshot.close()
    chk = _stack_drive(torch, np, chunked, chk_rec, requests, chunked=True)
    if oneshot.stats()['prefill_mode'] != 'captured' \
            or chunked.stats()['prefill_mode'] != 'captured':
        fail('serving stack: a prefill ran eagerly on the card')
    n_layers = cfg.llm.num_layers
    n = STACK_REQUESTS
    problems = []
    for name, rec, want in (
            ('one-shot', one, {
                'int8_matmul': n * (4 * n_layers + 1)
                + one['steps'] * (4 * n_layers + 1),
                'int8_matmul.prefill': n * 4 * n_layers,
                'int8_decode_attention': one['steps'] * n_layers}),
            ('chunked', chk, {
                'int8_matmul': chk['chunks'] * 4 * n_layers + n
                + chk['steps'] * (4 * n_layers + 1),
                'int8_matmul.prefill': 0,
                'int8_decode_attention': chk['steps'] * n_layers})):
        got = {k: rec['ran'][k] for k in want}
        if got != want:
            problems.append(f'{name} launches {got}, want {want}')
    want_chunks = sum((index - 1) // STACK_CHUNK + 1
                      for _, index in chk['first'])
    if chk['chunks'] != want_chunks:
        problems.append(f'{chk["chunks"]} chunk steps, want {want_chunks} '
                        f'(last_idx // {STACK_CHUNK} + 1 a request)')
    chk_tokens = [s.tokens for s in chk['sessions']]
    if chk_tokens != http_tokens:
        problems.append('the in-process chunked streams differ from the '
                        'HTTP run\'s')
    if problems:
        fail('serving stack: ' + '; '.join(problems))
    _chunked_against_one_shot(torch, np, chk, one, n, card)
    for rec in (one, chk):
        del rec['logits']          # and with it the recorder's buffer
    del one_rec, oneshot
    for name, rec in (('one-shot', one), ('chunked', chk)):
        ttft = [s.ttft * 1e3 for s in rec['sessions']]
        tokens = sum(len(s.tokens) for s in rec['sessions'])
        print(f'serving stack, {name}: {n} requests in {rec["wall"]:.2f} s, '
              f'{tokens / rec["wall"]:.1f} tok/s aggregate; longest gap '
              f'between two bursts a live stream saw '
              f'{_worst_stall(rec["stamps"]) * 1e3:.1f} ms; TTFT ms '
              f'{[round(t, 1) for t in ttft]} (mean {np.mean(ttft):.1f}); '
              f'{rec["steps"]} decode steps at '
              f'{1e3 * rec["decode_sec"] / max(rec["steps"], 1):.2f} ms a '
              f'step (each step also keeps its logits for the comparison); '
              f'{rec["chunks"]} chunk steps; launches '
              f'{ {k: v for k, v in rec["ran"].items() if v} } (exact) '
              f'[{card}]')
    # one more chunked request: prepare_one and last_logits against their
    # eager twins (last_logits' control: another position of the chunk)
    ptwin.arm({'_prepare_one': flip_images,
               '_last_logits': lambda ins: ((ins[0] + 1) % STACK_CHUNK,)})
    try:
        list(chunked.submit(*requests[1], max_new_tokens=2).token_stream())
    finally:
        ptwin.disarm()
    for body in ('_prepare_one', '_last_logits'):
        print(ptwin.line('serving stack, chunked engine', body, card))
    chunk_step_twin(torch, chunked, requests[1], card)
    chunked.close()
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the verify step, on a copy of the live decode state of an engine
    # with the lookahead (max_len grown by it): the first STACK_SLOTS
    # requests, the state copied after a burst with every slot live
    spec = BatchEngine(model, qp, spec_lookahead=STACK_LOOKAHEAD, **kw)
    snap = {}
    burst = spec._decode_burst

    def snapshot_burst():
        burst()
        if not snap and spec._active.all() and not spec._done_np.any():
            snap['state'] = spec.clone_state()
    spec._decode_burst = snapshot_burst
    try:
        live = [spec.submit(*r, max_new_tokens=STACK_MAX_NEW)
                for r in requests[:STACK_SLOTS]]
        for sess in live:
            list(sess.token_stream())
    finally:
        spec.close()
        spec._decode_burst = burst
    if 'state' not in snap:
        fail('serving stack: no burst ran with every slot live')
    verify_on_live_state(torch, np, spec, snap['state'], card)
    mm = chk['ran']['int8_matmul']
    att = chk['ran']['int8_decode_attention']
    print(f'serving stack phase: {time.perf_counter() - t0:.1f} s; device '
          f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak '
          f'[{card}]')
    del worker, chunked, spec, model, qp
    return mm, att


def engine_device_per_step(torch, np, worker, card: str):
    """Device time a decode step of the engine with every slot live: one
    more request per slot, after the timed run (starting and stopping the
    profiler would hold the queue), and ENGINE_PROFILED_BURSTS of their
    bursts each under torch.profiler on the engine's thread."""
    import threading
    from torch.profiler import ProfilerActivity, profile as tprofile
    engine, cfg = worker.engine, worker.cfg
    burst = engine._decode_burst
    profiled = []                   # (steps, {kernel: device ms})
    lengths = []                    # each profiled burst's first lengths

    def profiled_burst():
        if len(profiled) >= ENGINE_PROFILED_BURSTS or not engine._active.all():
            return burst()
        steps0 = engine._n_steps
        live = torch.as_tensor(engine._active, device=engine._pos.device) \
            & ~engine._done
        lengths.append(torch.where(live, engine._pos + 1, 0).tolist())
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            burst()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type.name == 'CUDA' and e.device_time > 0:
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.device_time / 1e3
        profiled.append((engine._n_steps - steps0, by_name))
    engine._decode_burst = profiled_burst

    def client(i):
        for _ in worker.generate_stream({
                'image': random_image(np, 100 + i, cfg.perceiver.image_size),
                'prompt': 'Find the red car.',
                'max_new_tokens': ENGINE_MAX_NEW, 'stream_chunk': 1}):
            pass
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(engine.max_slots)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    engine._decode_burst = burst
    if not profiled:
        print(f'engine: no burst ran with every slot live, device time a '
              f'step not measured [{card}]')
        return
    n = sum(p[0] for p in profiled)
    by_name = {}
    for _, names in profiled:
        for k, v in names.items():
            by_name[k] = by_name.get(k, 0.0) + v
    top = ', '.join(f'{k[:48]} {v / n:.3f}' for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:4])
    print(f'engine, {len(profiled)} bursts ({n} decode steps) with all '
          f'{engine.max_slots} slots live under torch.profiler: '
          f'{sum(by_name.values()) / n:.3f} ms of device time a step; the '
          f'longest kernels, ms a step: {top}; the slots\' kv lengths at '
          f'each burst\'s first step: {lengths} [{card}]')


# the detection stage (stage 1, scripts/det_pretrain.sh) at full width:
# DINOv2-L at 448 (frozen), DDETR d=256, 6+6 layers, 300 queries, one level
DET_BATCH = 8              # train_det's --per_device_train_batch_size
DET_IMAGES = {'coco': 24, 'sa1b': 8}   # 4 single-source batches an epoch
DET_MAX_BOXES = 50
DET_IMAGE_HW = (480, 640)
DET_PROFILED_STEPS = 2
DET_MATCHER_RUNS = 3
DET_EVAL_IMAGES = 8
DET_TWIN_BATCH = 2
# the reduced-depth twin (2 ViT layers, 2+2 DDETR layers): one step's
# losses and trainable gradients on the card against the CPU, both in f32
# after the ViT (the CPU takes the card's DDETR features).  Measured on an
# H100 at seeds 0 and 1: losses within 1.88e-7 and 2.06e-7, the whole
# gradient 4.36e-7 and 4.89e-7, the worst tensor 3.93e-6 and 8.11e-6 (the
# decoder's attention weights); the limits are four to five times those
DET_TWIN_LOSS_TOL = 1e-6      # relative, every loss key
DET_TWIN_GRAD_TOL = 2e-6      # relative Frobenius error, all trainable grads
DET_TWIN_TENSOR_TOL = 4e-5    # the same, per gradient tensor
# the card's matches scored on the CPU's costs, above the CPU's optimum,
# relative to it: near-identical queries may swap on rounding (at the
# init's kinks 2 targets did, 3.9e-10 above); anything above rounding is a
# fault
DET_TWIN_MATCH_TOL = 1e-5


def _det_dataset(np, root: str, seed: int):
    """A seeded COCO-format set in ``root``: PNG images of DET_IMAGE_HW with
    10 to DET_MAX_BOXES boxes each, a coco_box and an sa1b_box source, and
    its dataset config.  Returns (config path, {source: [(image, boxes
    xyxy)]})."""
    import os
    rng = np.random.default_rng(seed)
    h, w = DET_IMAGE_HW
    made, entries = {}, []
    for source, n in DET_IMAGES.items():
        images, anns, made[source] = [], [], []
        for i in range(n):
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            name = f'{source}{i}.png'
            with open(os.path.join(root, name), 'wb') as f:
                f.write(_png_bytes(img))
            images.append({'id': i, 'file_name': name, 'width': w,
                           'height': h})
            k = int(rng.integers(10, DET_MAX_BOXES + 1))
            wh = rng.uniform(24, 240, (k, 2))
            xy = rng.uniform(0, 1, (k, 2)) * (np.array([w, h]) - wh)
            for (x, y), (bw, bh) in zip(xy, wh):
                anns.append({'id': len(anns), 'image_id': i,
                             'bbox': [float(x), float(y), float(bw),
                                      float(bh)],
                             'area': float(bw * bh), 'category_id': 1,
                             'iscrowd': 0})
            made[source].append((img, np.concatenate([xy, xy + wh], 1)))
        ann = os.path.join(root, f'{source}.json')
        with open(ann, 'w') as f:
            json.dump({'images': images, 'annotations': anns,
                       'categories': [{'id': 1, 'name': 'object'}]}, f)
        entries.append(f"dict(type='{source}_box', ann_file={ann!r}, "
                       f"img_prefix={root!r})")
    cfg_file = os.path.join(root, 'det_data.py')
    with open(cfg_file, 'w') as f:
        f.write('datasets = [' + ',\n            '.join(entries) + ']\n')
    return cfg_file, made


def train_det_full_width(torch, np, seed: int, card: str):
    """Stage 1 through its entry point at full width (phase 11): train_det
    for an epoch of DET_BATCH-image batches from both sources, then a
    resume for one more step; checks, ms/step, peak memory, the device's
    busy share, both matchers' ms per step, evaluate_detector on
    DET_EVAL_IMAGES images and run_ddetr on the export."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile as tprofile

    from groma_tpu_torch.checkpoint.loader import random_perceiver
    from groma_tpu_torch.data.build import build_multi_datasets, collate_det
    from groma_tpu_torch.data.image_pipeline import normalize, resize
    from groma_tpu_torch.eval import run_ddetr
    from groma_tpu_torch.eval.det_eval import evaluate_detector
    from groma_tpu_torch.models import ddetr_loss as dl
    from groma_tpu_torch.ops import matcher
    from groma_tpu_torch.train import train_det
    from groma_tpu_torch.train.optimizer import (det_lr_mult_rules,
                                                 freeze_predicate, make_adamw)
    from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg_file, made = _det_dataset(np, root, seed + 11)
        out = os.path.join(root, 'out')
        argv = ['--dataset_config', cfg_file, '--output_dir', out,
                '--per_device_train_batch_size', str(DET_BATCH),
                '--warmup_steps', '1', '--logging_steps', '1',
                '--seed', str(seed)]
        print(f'detection stage: {sum(DET_IMAGES.values())} synthetic '
              f'{DET_IMAGE_HW[1]}x{DET_IMAGE_HW[0]} images ({DET_IMAGES}), '
              f'10 to {DET_MAX_BOXES} boxes each, made in '
              f'{time.perf_counter() - t0:.1f} s [{card}]')
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_det.main(argv + ['--num_train_epochs', '1'])
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = first['model'].cfg
        n = first['step']
        t0 = time.perf_counter()
        second = train_det.main(argv + ['--num_train_epochs',
                                        str((n + 1) / n)])
        second_s = time.perf_counter() - t0
        if second['step'] != n + 1 or len(second['losses']) != 1:
            fail(f'train_det resumed to step {second["step"]} with '
                 f'{len(second["losses"])} new steps, want {n + 1} and 1')
        losses = [d['loss'] for d in first['losses'] + second['losses']]
        if not all(math.isfinite(v) for d in first['losses']
                   + second['losses'] for v in d.values()):
            fail(f'train_det: a loss is not finite: {losses}')
        model = second['model']
        fresh = random_perceiver(cfg, seed=seed, device='cuda')
        start = dict(fresh.named_parameters())
        moved_vit = [k for k, p in model.named_parameters()
                     if k.startswith('vis_encoder.')
                     and not torch.equal(p, start[k])]
        still = [k for k, p in model.named_parameters()
                 if not k.startswith('vis_encoder.')
                 and torch.equal(p, start[k])]
        del fresh, start
        entry = sorted(first['step_seconds'][1:])
        del first
        if moved_vit:
            fail(f'train_det: frozen ViT parameters moved: {moved_vit[:3]}')
        if still:
            fail(f'train_det: parameters that did not move: {still[:5]}')
        print(f'train_det: {n} steps then a resume for 1 ({first_s:.1f} s '
              f'and {second_s:.1f} s through the entry point, the model '
              f'built, the data loaded, checkpoints and the export '
              f'written), losses '
              + ', '.join(f'{v:.3f}' for v in losses)
              + f'; {entry[len(entry) // 2] * 1e3:.1f} ms a step (median '
              f'after the first, host clock, synchronized); peak '
              f'{peak:.2f} GiB at B={DET_BATCH}; the ViT bitwise unchanged, '
              f'every other tensor moved [{card}]')

        # steps of the entry point's own step function on one batch of
        # each source, timed and then profiled
        ds = build_multi_datasets(cfg_file, image_size=cfg.image_size)
        batches = {}
        for k, src in enumerate(DET_IMAGES):
            lo = int(ds.offsets[k])
            batches[src] = det_batch_to(collate_det(
                [ds[lo + i] for i in range(DET_BATCH)]), 'cuda')
        opt = make_adamw(model, 2e-4, weight_decay=1e-4, max_grad_norm=1.0,
                         lr_mult_rules=det_lr_mult_rules(0.1),
                         frozen_pred=freeze_predicate(freeze_vis_encoder=True))
        steps = {src: make_det_train_step(model, cfg.ddetr, opt, src)
                 for src in DET_IMAGES}
        times = []
        for i in range(4):
            src = ('coco', 'sa1b')[i % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[src](batches[src])['loss'].item()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = sorted(times[1:])
        print(f'det step (B={DET_BATCH}, 300 queries, 1024 encoder tokens, '
              f'up to {DET_MAX_BOXES} targets an image), batches in memory: '
              f'{warm[len(warm) // 2] * 1e3:.1f} ms median of {len(warm)} '
              f'warm steps (first {times[0] * 1e3:.1f}) [{card}]')
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DET_PROFILED_STEPS):
                steps['coco'](batches['coco'])['loss'].item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type.name == 'CUDA' and e.device_time > 0]
        device_ms = sum(e.device_time for e in events) / 1e3
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        k = DET_PROFILED_STEPS
        print(f'profiled {k} det steps: wall {wall * 1e3 / k:.1f} ms/step, '
              f'device kernel time {device_ms / k:.1f} ms/step, busy '
              f'{100 * device_ms / (wall * 1e3):.1f} % [{card}]')
        for name, ms in top:
            print(f'  {ms / k:9.2f} ms/step  {name[:100]} [{card}]')

        # both matchers at these shapes, on one forward's outputs
        with torch.no_grad():
            outs = model(batches['coco']['images'])
        for kind in ('hungarian', 'auction'):
            real = dl.MATCHERS[kind]
            calls = []

            def timed(c, v, _real=real, _calls=calls):
                torch.cuda.synchronize()
                t = time.perf_counter()
                a = _real(c, v)
                torch.cuda.synchronize()
                _calls.append((tuple(c.shape), time.perf_counter() - t))
                return a
            dl.MATCHERS[kind] = timed
            try:
                for _ in range(DET_MATCHER_RUNS):
                    loss = dl.ddetr_loss(outs, batches['coco']['targets'],
                                         cfg.ddetr, 'coco', matcher=kind)
            finally:
                dl.MATCHERS[kind] = real
            per = len(calls) // DET_MATCHER_RUNS
            ms = sorted(sum(t for _, t in calls[i * per:(i + 1) * per])
                        for i in range(DET_MATCHER_RUNS))
            shapes = ', '.join(str(s) for s, _ in calls[:per])
            print(f'{kind} matcher: {ms[len(ms) // 2] * 1e3:.2f} ms per '
                  f'step (median of {DET_MATCHER_RUNS}; {per} calls over '
                  f'{shapes}{", convergence read every %d rounds" % matcher.CHECK_EVERY if kind == "auction" else ""}), '
                  f'loss {float(loss["loss"]):.4f} [{card}]')
            if not math.isfinite(float(loss['loss'])):
                fail(f'{kind} matcher: loss {float(loss["loss"])}')

        # the detector's COCO-protocol evaluation and the demo on the export
        samples = []
        for i, (img, boxes) in enumerate(made['coco'][:DET_EVAL_IMAGES]):
            sized, _ = resize(img, (cfg.image_size, cfg.image_size))
            samples.append({'images': normalize(sized), 'image_id': i,
                            'ori_shape': img.shape[:2],
                            'gt': [(0, b) for b in boxes]})
        t0 = time.perf_counter()
        summary = evaluate_detector(model.eval(), samples)
        ev_s = time.perf_counter() - t0
        if not all(math.isfinite(v) for v in summary.values()):
            fail(f'evaluate_detector: {summary}')
        print(f'evaluate_detector on {len(samples)} images in {ev_s:.1f} s: '
              f'{json.dumps(summary)} [{card}]')
        t0 = time.perf_counter()
        kept = run_ddetr.main(['--model-dir', out, '--image-file',
                               os.path.join(root, 'coco0.png'),
                               '--output-image', ''])
        if kept.ndim != 2 or not np.isfinite(kept).all():
            fail(f'run_ddetr: kept boxes {kept!r}')
        print(f'run_ddetr on the export: {len(kept)} boxes kept, '
              f'{time.perf_counter() - t0:.1f} s with the load [{card}]')
        del model, opt, steps, batches, outs, second
        return check_det_twin(torch, np, made, cfg_file, seed, card)


def check_det_twin(torch, np, made, cfg_file, seed: int, card: str):
    """The reduced-depth twin (2 ViT layers, 2+2 DDETR layers, full widths):
    one detection step on the card against the same weights and batch on
    the CPU, every loss, the matches and every trainable gradient.  The CPU
    takes the card's DDETR features (the bf16 mean of the ViT's last
    hidden states), so both run the head in f32 from the same values."""
    from groma_tpu_torch.checkpoint.loader import random_perceiver
    from groma_tpu_torch.config import DDETRConfig, PerceiverConfig, ViTConfig
    from groma_tpu_torch.data.build import build_multi_datasets, collate_det
    from groma_tpu_torch.models import ddetr_loss as dl
    from groma_tpu_torch.models.perceiver import Perceiver
    from groma_tpu_torch.train.optimizer import (det_lr_mult_rules,
                                                 freeze_predicate, make_adamw)
    from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step
    cfg = PerceiverConfig(vit=ViTConfig(num_layers=2), ddetr=DDETRConfig(
        encoder_layers=2, decoder_layers=2))
    card_model = random_perceiver(cfg, seed=seed + 1, device='cuda')
    # off the bilinear weight's kinks: at init every sampling point lies on
    # a cell's centre line (zero offset weights and box deltas, ring
    # offsets of 0.2 cell), where the slope of grid_sample's weight flips
    # with the last bit of the location; the parameters that start at zero
    # get a little noise, as any training step gives them
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 2)
    with torch.no_grad():
        for p in card_model.parameters():
            if not p.any():
                p.normal_(0.0, 1e-2, generator=gen)
    cpu_model = Perceiver(cfg, device='meta', vit_dtype=torch.float32,
                          vit_compute_dtype=torch.bfloat16)
    cpu_model.load_state_dict({k: v.to('cpu', copy=True) for k, v in
                               card_model.state_dict().items()}, assign=True)
    states = []
    features = card_model.ddetr_features

    def recording(hidden_states):
        states.append(features(hidden_states))
        return states[-1]
    card_model.ddetr_features = recording
    cpu_model.encode_image = lambda images, use_flash=False: ()
    cpu_model.ddetr_features = lambda hidden_states: states[0].cpu()
    ds = build_multi_datasets(cfg_file, image_size=cfg.image_size)
    batch = collate_det([ds[i] for i in range(DET_TWIN_BATCH)])
    real = dl.MATCHERS['hungarian']
    card_calls, cpu_calls = [], []

    def card_match(c, v):
        a = real(c, v)
        card_calls.append((c.float().cpu(), a.cpu()))
        return a

    def cpu_match(c, v):
        # the CPU's own optimum is kept for the tie check; the step runs
        # on the card's matches, so both differentiate the same pairs
        cpu_calls.append((c.float().cpu(), real(c, v)))
        return card_calls[len(cpu_calls) - 1][1]
    results = {}
    for name, model, dev, match in (('card', card_model, 'cuda', card_match),
                                    ('cpu', cpu_model, 'cpu', cpu_match)):
        dl.MATCHERS['hungarian'] = match
        opt = make_adamw(model, 2e-4, weight_decay=1e-4, max_grad_norm=1.0,
                         lr_mult_rules=det_lr_mult_rules(0.1),
                         frozen_pred=freeze_predicate(freeze_vis_encoder=True))
        grads = {}
        real_step = opt.step

        def keep_grads(_model=model, _grads=grads, _step=real_step):
            _grads.update({k: p.grad.float().cpu().clone() for k, p in
                           _model.named_parameters() if p.grad is not None})
            return _step()
        opt.step = keep_grads
        t0 = time.perf_counter()
        try:
            losses = make_det_train_step(model, cfg.ddetr, opt, 'coco')(
                det_batch_to(batch, dev))
        finally:
            dl.MATCHERS['hungarian'] = real
        losses = {k: float(v) for k, v in losses.items() if k != 'updated'}
        results[name] = (losses, grads, time.perf_counter() - t0)
    (g_loss, g_grads, g_s), (c_loss, c_grads, c_s) = results['card'], \
        results['cpu']
    # the card's matches against the CPU's own on the CPU's costs: a match
    # may differ only where its total cost ties the CPU's optimum

    def cost_of(cost, assign):
        b, t = torch.nonzero(assign >= 0, as_tuple=True)
        return cost[b, assign[b, t], t].double().sum().item()
    differ, gap = 0, 0.0
    for (_, g_a), (c_cost, c_a) in zip(card_calls, cpu_calls):
        differ += int((g_a != c_a).sum())
        best = cost_of(c_cost, c_a)
        gap = max(gap, (cost_of(c_cost, g_a) - best) / abs(best))
    if len(card_calls) != len(cpu_calls) or gap > DET_TWIN_MATCH_TOL:
        fail(f'detection twin: the card matched {differ} targets otherwise '
             f'than the CPU, {gap:.2e} above its optimum (tol '
             f'{DET_TWIN_MATCH_TOL})')
    if g_grads.keys() != c_grads.keys() or not g_grads:
        fail('detection twin: the card and the CPU trained different '
             'parameters')
    loss_rel = max(abs(g_loss[k] - c_loss[k]) / max(abs(c_loss[k]), 1e-12)
                   for k in c_loss)
    # the decoder's key biases get no gradient in exact arithmetic (softmax
    # ignores a shift shared by every key): both sides compute rounding
    rel = {k: ((g_grads[k] - c_grads[k]).norm()
               / c_grads[k].norm().clamp(min=1e-30)).item() for k in c_grads
           if not k.endswith('k_proj.bias')}
    total = (sum(((g_grads[k] - c_grads[k]) ** 2).sum() for k in c_grads)
             / sum((c_grads[k] ** 2).sum() for k in c_grads)).sqrt().item()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    ok = (loss_rel <= DET_TWIN_LOSS_TOL and total <= DET_TWIN_GRAD_TOL
          and all(v <= DET_TWIN_TENSOR_TOL for v in rel.values())
          and all(math.isfinite(v) for v in g_loss.values()))
    print(f'detection twin (2 ViT layers, 2+2 DDETR layers, full widths, '
          f'B={DET_TWIN_BATCH}): {len(card_calls)} matcher calls, {differ} '
          f'targets matched otherwise on the CPU, at most {gap:.2e} of the '
          f'total cost above the CPU optimum (tol {DET_TWIN_MATCH_TOL}; '
          f'both steps on the card\'s matches); losses card vs CPU worst '
          f'rel {loss_rel:.2e} (tol {DET_TWIN_LOSS_TOL}), loss {g_loss["loss"]:.6f} vs '
          f'{c_loss["loss"]:.6f}; {len(c_grads)} trainable gradients, '
          f'whole-gradient rel err {total:.2e} (tol {DET_TWIN_GRAD_TOL}), '
          f'worst tensors ' + ', '.join(f'{k} {v:.2e}' for k, v in worst)
          + f' (tol {DET_TWIN_TENSOR_TOL}) {"ok" if ok else "FAIL"}; card '
          f'step {g_s * 1e3:.1f} ms (cold), CPU {c_s:.1f} s [{card}]')
    if not ok:
        fail('detection twin: the card step disagrees with the CPU')
    del card_model, cpu_model, results, states
    return True


# ------------- GQA, DINOv2-giant, the evaluation kits and FSDP (phase 12)
# GQA: Groma at GromaConfig() widths with 8 KV heads of 128 under its 32
# query heads; the fused qkv is N = 4096 + 2 x 1024 columns wide
GQA_KV_HEADS = 8
GQA_QKV = (4096, 4096 + 2 * GQA_KV_HEADS * 128)
GQA_ROWS = (1, 8, 2048)
GQA_MAX_NEW = 16
GQA_REQUESTS = 8            # through the contiguous int4 engine's 8 slots
# DINOv2-giant (dinov2-giant's config: hidden 1536, 40 layers, 24 heads of
# 64, the SwiGLU FFN) at 448, B=1, with the bidirectional flash kernel
# against the plain attention: each layer alone on the plain path's input
# to it, and the whole 40-layer forward (a drift limit: bf16 rounding of
# p in the kernel against bf16 scores in the plain path, carried through
# 40 layers of random weights); measured on an H100 1.04e-2 (worst layer)
# and 4.1e-2 (the forward): limits about three and two and a half times
GIANT_LAYER_TOL = 3e-2      # relative to max|layer output|
GIANT_DEPTH_TOL = 0.1       # relative to max|last hidden|
# the eval kits at GromaConfig() widths, random weights
REGION_CAP_IMAGES = 3
KIT_MAX_NEW = 8
LLAVA_QUESTIONS = 2
# the 1-rank FSDP step against the same step without a group (stage 3 at
# check_stage3's 2 LLM layers), the trained leaves' gradients and updates
# (after - start) in relative Frobenius norm.  Adam's first step moves an
# element by about lr * sign(g) whatever g's scale, so the update checks
# the step's direction and the gradient its scale.  The step is not
# bitwise repeatable on the card (the flash backward adds dq with atomics;
# the repeat's worst leaf is a convolution's weight): on an H100 two steps
# without a group part by 1.1e-3 (gradients, all leaves; 2.8e-3 to 2.9e-3
# the worst leaf) and 1.7e-2 (updates; 5.4e-2 to 6.0e-2 the worst, a small
# norm layer's), where a near-zero gradient element takes the other sign;
# the limits sit 5 to 35 x above that and 5 to 50 x below the controls
# (no update 1, the sign flipped 2, the gradient halved 0.5)
FSDP_LOSS_TOL = 1e-5        # relative
FSDP_GRAD_ALL_TOL = 1e-2    # relative Frobenius, all trained leaves
FSDP_GRAD_LEAF_TOL = 1e-1   # the same, the worst leaf
FSDP_UPDATE_ALL_TOL = 1e-1  # relative Frobenius, all trained leaves
FSDP_UPDATE_LEAF_TOL = 3e-1  # the same, the worst leaf


def check_gqa_qkv_matmuls(torch, gen, timer, card):
    """#1 and #7 at the GQA qkv width (K, N) = GQA_QKV against their plain
    versions at M = 1, 8 (decode tiles) and 2048 (prefill tiles), each
    called twice (bitwise equal); kernel, plain, bound and library times.
    Returns {(kind, M): (max_abs_err, [ms, plain ms], (bound ms, by),
    library ms)}."""
    from groma_tpu_torch.ops.quant import (DENSE_MIN_ROWS, int8_matmul,
                                           int8_matmul_dense_reference,
                                           int8_matmul_reference)
    from groma_tpu_torch.ops.quant4 import int4_matmul, int4_matmul_reference
    dev = 'cuda'
    k, n = GQA_QKV
    out = {}
    for kind in ('int8', 'int4'):
        if kind == 'int8':
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            scale = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4
            w_bytes = k * n + 4 * n
        else:
            w = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                              dtype=torch.uint8)
            scale = torch.rand((k // 256, n), generator=gen, device=dev) \
                * 1e-3 + 1e-4
            w_bytes = k * n // 2 + (k // 256) * n * 4
        for m in GQA_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            if kind == 'int8':
                fn = lambda: int8_matmul(x, w, scale)   # noqa: E731
                plain = int8_matmul_dense_reference if m >= DENSE_MIN_ROWS \
                    else int8_matmul_reference
            else:
                fn = lambda: int4_matmul(x, w, scale)   # noqa: E731
                plain = int4_matmul_reference
            got, again = fn(), fn()
            stable = bool(torch.equal(got, again))
            want = plain(x, w, scale).float()
            err = (got.float() - want).abs()
            # f32 sums in another order, then one bf16 rounding each
            tol = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
            ok = bool((err <= tol).all()) and stable \
                and bool(torch.isfinite(got).all())
            ms = timer(fn)
            plain_ms = timer(lambda: plain(x, w, scale))
            bnd = bound(w_bytes + 2 * m * (k + n), 2 * m * k * n)
            if kind == 'int8':
                w_t = w.T.contiguous()
                lib = library_time(
                    torch, timer, f'torch._weight_int8pack_mm M={m} GQA qkv',
                    lambda: torch._weight_int8pack_mm(
                        x, w_t, scale.to(torch.bfloat16)), want, card)
                del w_t
            else:
                try:
                    tg = _tinygemm(torch, x, w, scale)
                except (RuntimeError, TypeError, AttributeError) as e:
                    print(f'  library torch._weight_int4pack_mm: none '
                          f'({type(e).__name__}) [{card}]')
                    tg = None
                lib = tg and library_time(
                    torch, timer, f'torch._weight_int4pack_mm M={m} GQA qkv',
                    tg, want, card)
            tile = 'prefill' if (m >= DENSE_MIN_ROWS if kind == 'int8'
                                 else m > 8) else 'decode'
            print(f'{kind}_matmul {tile} tile M={m} GQA qkv K={k} N={n}: '
                  f'max_abs_err {err.max().item():.3e}, rel '
                  f'{err.max().item() / want.abs().max().item():.3e} of '
                  f'max|plain| (tol 2^-7*|plain| + 1e-4*max|plain|) '
                  f'{"ok" if ok else "FAIL"}, two calls '
                  f'{"bitwise equal" if stable else "DIFFER"}; kernel '
                  f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f} % of '
                  f'it [{card}]')
            if not ok:
                fail(f'{kind}_matmul disagrees with its plain version at the '
                     f'GQA qkv width, M={m}, or two calls differ')
            out[(kind, m)] = (err.max().item(), [ms, plain_ms], bnd, lib)
            del x, got, again, want, err
        del w, scale
    return out


def check_gqa_llm_path(torch, seed: int, card: str):
    """The quantized LLaMA path at GQA (32 query heads over 8 KV heads),
    full width and two layers, int8 and int4 weights over an int8 KV cache:
    a prefill (M = 400: the prefill tiles) and decode steps (JAX's route
    at rep > 1: the layer's cache dequantized, the K/V heads repeated,
    the plain attention chain) on the card against the CPU."""
    from groma_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_forward,
                                                    quantize_llama_params)
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    cfg = LlamaConfig(num_layers=2, num_kv_heads=GQA_KV_HEADS)
    torch.manual_seed(seed)
    with torch.no_grad():
        llm = LlamaForCausalLM(cfg, device='cuda')
        sd = llm.state_dict()
        trees = {bits: quantize_llama_params(sd, cfg, bits=bits)
                 for bits in (8, 4)}
        del llm, sd
    b, s, steps = 2, 200, 4
    gen = torch.Generator().manual_seed(seed)
    emb = torch.randn((b, s, cfg.hidden_size), generator=gen)
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[1, 150:] = False
    pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
    steps_in = [torch.randn((b, 1, cfg.hidden_size), generator=gen)
                for _ in range(steps)]

    def run(qp, device):
        def move(t):
            return t.to(device)
        tree = {'norm': move(qp['norm']),
                'layers': [{k: ({kk: move(vv) for kk, vv in v.items()}
                                if isinstance(v, dict) else move(v))
                            for k, v in lp.items()} for lp in qp['layers']]}
        cache = make_quant_kv_cache(cfg, b, s + steps, device=device)
        h, cache = quant_llama_forward(tree, cfg, move(emb), move(valid),
                                       move(pos), cache)
        outs = [h.float().cpu()]
        for i, x in enumerate(steps_in):
            h, cache = quant_llama_forward(
                tree, cfg, move(x), move(torch.ones((b, 1), dtype=bool)),
                move(pos[:, -1:] + 1 + i), cache)
            outs.append(h.float().cpu())
        return outs

    for bits, qp in trees.items():
        n_att = int8_decode_attention.launches
        with torch.no_grad():
            got, want = run(qp, 'cuda'), run(qp, 'cpu')
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            # bf16 activations rounded at other points: as check_llm_path
            err = (g - w).abs().max().item() / w.abs().max().item()
            worst = max(worst, err)
            if not (err <= 3e-2 and torch.isfinite(g).all()):
                fail(f'GQA {bits}-bit LLaMA path: step {i} differs from the '
                     f'CPU plain path by {err:.3e}')
        if int8_decode_attention.launches != n_att:
            fail('GQA decode launched the int8 decode-attention kernel (#2 '
                 'runs only at num_kv_heads == num_heads, as in JAX)')
        print(f'GQA ({cfg.num_heads} query heads over {cfg.num_kv_heads} KV '
              f'heads) {bits}-bit LLaMA path, full width, 2 layers, B={b}: '
              f'prefill {s} tokens + {steps} decode steps over the int8 '
              f'cache (dequantized, heads repeated; #2 not launched) match '
              f'the CPU plain path within {worst:.3e} x max|hidden| (tol '
              f'3e-2) [{card}]')
    del trees


def serve_gqa_full_width(torch, np, seed: int, card: str):
    """GQA serving at GromaConfig() widths with GQA_KV_HEADS KV heads, 32
    layers: QuantGenerator(kv_bits=8) on int8 weights (two requests, B=1,
    GQA_MAX_NEW tokens, no EOS) and the contiguous BatchEngine (no paging:
    GQA refuses it, as in JAX) on int4 weights with 8 slots and
    GQA_REQUESTS requests.  Counts zeroed before each run and read after:
    the prefill tiles exactly 4 x 32 a prefill, the decode tiles
    launched, #2 and #8 never.  Returns {'int8': (decode tile launches,
    prefill tile launches), 'int4': (...)}."""
    from groma_tpu_torch.checkpoint.loader import random_groma
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu_torch.eval.generate_quant import QuantGenerator
    from groma_tpu_torch.eval.rec import build_rec_prompt
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.serve.engine import BatchEngine
    base = GromaConfig()
    cfg = base.replace(llm=base.llm.replace(num_kv_heads=GQA_KV_HEADS))
    n_layers = cfg.llm.num_layers
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    prompts = [build_rec_prompt(p, tok, spec) for p in SERVED_PROMPTS]
    images = [random_image(np, seed + 70 + i, cfg.perceiver.image_size)
              for i in range(GQA_REQUESTS)]
    launched = {}
    for bits in (8, 4):
        t0 = time.perf_counter()
        model, qp = random_groma(cfg, seed=seed, device='cuda', bits=bits)
        built = time.perf_counter() - t0
        width = qp['layers'][0]['qkv_proj']['q'].shape[1]
        if width != GQA_QKV[1]:
            fail(f'GQA qkv is {width} columns wide, not {GQA_QKV[1]}')
        zero_counts()
        t0 = time.perf_counter()
        if bits == 8:
            gen = QuantGenerator(model, qp, max_len=cfg.max_seq_len + 64,
                                 kv_bits=8)
            outs = []
            for i, t in enumerate(prompts[:2]):
                toks, vis = gen.generate(
                    images[i][None], t['input_ids'][None],
                    t['region_slot'][None], t['valid'][None],
                    max_new_tokens=GQA_MAX_NEW, eos_id=-1)
                outs.append(np.asarray(toks)[0])
            st = gen.last_stats
            n_prefills = 2
            what = (f'QuantGenerator(kv_bits=8), int8, 2 requests, '
                    f'{GQA_MAX_NEW} tokens each, the second: prefill '
                    f'{st["prefill_ms"]:.1f} ms, decode '
                    f'{st["decode_ms_per_token"]:.2f} ms/token (host clock)')
            del gen
        else:
            engine = BatchEngine(model, qp, max_slots=8,
                                 max_len=cfg.max_seq_len + GQA_MAX_NEW + 8,
                                 eos_id=-1, chunk=8,
                                 max_new_tokens=GQA_MAX_NEW, kv_bits=8)
            try:
                sessions = [engine.submit(images[i],
                                          prompts[i % 3]['input_ids'],
                                          prompts[i % 3]['region_slot'],
                                          prompts[i % 3]['valid'])
                            for i in range(GQA_REQUESTS)]
                outs = [np.asarray(list(s.token_stream())) for s in sessions]
                st = engine.stats()
            finally:
                engine.close()
            n_prefills = GQA_REQUESTS
            what = (f'contiguous BatchEngine, int4 + int8 KV, 8 slots, '
                    f'{GQA_REQUESTS} requests of {GQA_MAX_NEW} tokens: '
                    f'{st["decode_ms_per_step"]} ms/step, '
                    f'{st["tokens_per_sec"]} tok/s, mean TTFT '
                    f'{st["mean_ttft_sec"]} s (stats())')
            del engine
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = device_launches()
        name = f'int{bits}_matmul'
        pre = ran[f'{name}.prefill']
        dec = ran[name] - pre
        # a new prefill graph's warm-up runs the prefill once more
        n_prefills += warmups()
        ok = (pre == 4 * n_layers * n_prefills and dec > 0
              and ran['int8_decode_attention'] == 0
              and ran['paged_int8_decode_attention'] == 0
              and all(len(o) == GQA_MAX_NEW and ((o >= 0)
                      & (o < cfg.vocab_size)).all() for o in outs))
        print(f'GQA serving ({cfg.llm.num_heads} query heads over '
              f'{cfg.llm.num_kv_heads} KV heads, qkv N={width}), {what}: '
              f'{seconds:.1f} s (weights drawn in {built:.1f} s), launches '
              f'{name} prefill tile {pre} (want {4 * n_layers * n_prefills}), '
              f'decode tile {dec}, int8_decode_attention '
              f'{ran["int8_decode_attention"]}, paged '
              f'{ran["paged_int8_decode_attention"]}; first tokens '
              f'{outs[0][:8].tolist()} {"ok" if ok else "FAIL"} [{card}]')
        if not ok:
            fail(f'GQA serving ({name}): launches or tokens wrong')
        launched[f'int{bits}'] = (dec, pre)
        del model, qp
        gc.collect()
        torch.cuda.empty_cache()
    return launched


def dinov2_giant_forward(torch, seed: int, card: str):
    """DINOv2-giant at its published widths with the SwiGLU FFN, 448², B=1,
    weights in bf16: the forward with use_flash (one bidirectional flash
    launch a layer, counted) against the plain forward; each layer alone
    on the plain path's input to it within GIANT_LAYER_TOL, the whole
    forward within GIANT_DEPTH_TOL; #3 at its shape (1, 24, 1025, 64)
    timed against its plain version and SDPA.  Returns the flash launches
    of the checked forward and #3's row tuple."""
    from groma_tpu_torch.checkpoint.loader import _fill
    from groma_tpu_torch.models.dinov2 import Dinov2Model
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.ops.flash_attention import flash_fwd, mha_reference
    import torch.nn.functional as F
    pc = GromaConfig().perceiver
    c = pc.vit.replace(hidden_size=1536, num_layers=40, num_heads=24,
                       use_swiglu_ffn=True)
    model = Dinov2Model(c, deploy_image_size=pc.image_size, device='meta',
                        dtype=torch.bfloat16)
    model.to_empty(device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    with torch.no_grad():
        _fill(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    images = torch.randn((1, pc.image_size, pc.image_size, 3),
                         generator=gen, device='cuda')
    times = {}
    with torch.no_grad():
        for flash in (True, False):
            model(images, use_flash=flash)            # warm
            torch.cuda.synchronize()
            flash_fwd.launches.update(dict.fromkeys(flash_fwd.launches, 0))
            t0 = time.perf_counter()
            last, hidden = model(images, use_flash=flash)
            torch.cuda.synchronize()
            times[flash] = (time.perf_counter() - t0) * 1e3
            n = flash_fwd.launches['bidirectional']
            if flash:
                flash_last, flash_n = last, n
            elif n:
                fail('the plain DINOv2-g forward launched the flash kernel')
        plain_last, plain_hidden = last, hidden
        depth = ((flash_last.float() - plain_last.float()).abs().max()
                 / plain_last.float().abs().max()).item()
        layer_worst = 0.0
        for i, layer in enumerate(model.encoder.layer):
            x = plain_hidden[i]
            a = layer(x, use_flash=True).float()
            b = layer(x, use_flash=False).float()
            layer_worst = max(layer_worst, ((a - b).abs().max()
                                            / b.abs().max()).item())
    ok = (flash_n == c.num_layers and layer_worst <= GIANT_LAYER_TOL
          and depth <= GIANT_DEPTH_TOL
          and bool(torch.isfinite(flash_last).all()))
    print(f'DINOv2-giant ({n_params / 1e9:.3f} B parameters: hidden '
          f'{c.hidden_size}, {c.num_layers} layers, {c.num_heads} heads, '
          f'SwiGLU FFN {model.encoder.layer[0].mlp.weights_out.in_features} '
          f'wide) at {pc.image_size}², B=1, bf16: forward {times[True]:.1f} ms '
          f'with use_flash ({flash_n} bidirectional flash launches, want '
          f'{c.num_layers}), {times[False]:.1f} ms plain (host clock, one '
          f'synchronized run); each layer on the plain input within '
          f'{layer_worst:.3e} x max|out| (tol {GIANT_LAYER_TOL}), the whole '
          f'forward within {depth:.3e} x max|last hidden| (tol '
          f'{GIANT_DEPTH_TOL}) {"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('DINOv2-giant: the flash forward disagrees with the plain one '
             'or missed a layer')
    del model, hidden, plain_hidden, flash_last, plain_last
    # #3 at the giant's own shape
    timer = Timer('cuda')
    b, h, s, d = 1, c.num_heads, 1 + (pc.image_size // c.patch_size) ** 2, \
        c.hidden_size // c.num_heads
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device='cuda').to(
        torch.bfloat16) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.bool, device='cuda')
    out = flash_fwd(q, k, v, mask, causal=False, scale=d ** -0.5)[0]
    want = mha_reference(q, k, v, mask, causal=False, scale=d ** -0.5)
    want = want[0] if isinstance(want, tuple) else want
    diff = (out.float() - want.float()).abs()
    # f32 sums in another order, p rounded to bf16: check_flash's limit
    ok3 = bool((diff <= 2.0 ** -7 * want.float().abs()
                + 2.0 ** -9 * want.float().abs().max()).all())
    err = diff.max().item()
    ms = timer(lambda: flash_fwd(q, k, v, mask, causal=False,
                                 scale=d ** -0.5))
    plain_ms = timer(lambda: mha_reference(q, k, v, mask, causal=False,
                                           scale=d ** -0.5))
    bnd = bound(4 * b * h * s * d * 2 + b * s, 4 * b * h * s * s * d)
    lib = library_time(torch, timer, 'F.scaled_dot_product_attention '
                       '(#3, DINOv2-g)', lambda: F.scaled_dot_product_attention(
                           q, k, v, scale=d ** -0.5), want, card)
    print(f'flash_fwd bidirectional (#3) at DINOv2-g {(b, h, s, d)}: '
          f'max_abs_err {err:.3e} (tol 2^-7*|plain| + 2^-9*max|plain|) '
          f'{"ok" if ok3 else "FAIL"}; kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), '
          f'{100 * bnd[0] / ms:.1f} % of it [{card}]')
    if not ok3:
        fail('flash_fwd disagrees with its plain version at DINOv2-g')
    return flash_n, (err, [ms, plain_ms], bnd, lib)


def region_caption_full_width(torch, np, seed: int, card: str):
    """Region captioning through its CLI (eval/region_cap.main) at
    GromaConfig() widths with random weights on the card: a COCO-format
    file of REGION_CAP_IMAGES PNG images, each with one box and its
    caption, KIT_MAX_NEW new tokens a caption, the stub tokenizer; then
    its shard and merge_and_score's CIDEr, BLEU, METEOR and ROUGE-L."""
    import os
    import tempfile

    from groma_tpu_torch.eval import region_cap
    rng = np.random.default_rng(seed + 80)
    with tempfile.TemporaryDirectory() as root:
        images, anns = [], []
        for i in range(REGION_CAP_IMAGES):
            h, w = 480, 560 + 40 * i
            name = f'region{i}.png'
            with open(os.path.join(root, name), 'wb') as f:
                f.write(_png_bytes(rng.integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)))
            images.append({'id': i, 'file_name': name, 'width': w,
                           'height': h})
            anns.append({'id': i, 'image_id': i, 'category_id': 1,
                         'bbox': [40.0 + 20 * i, 60.0, 200.0, 150.0],
                         'area': 30000.0, 'iscrowd': 0,
                         'caption': f'a red object number {i}'})
        ann = os.path.join(root, 'region_cap.json')
        with open(ann, 'w') as f:
            json.dump({'images': images, 'annotations': anns,
                       'categories': [{'id': 1, 'name': 'object'}]}, f)
        out = os.path.join(root, 'shards')
        t0 = time.perf_counter()
        scores = region_cap.main([
            '--model-dir', 'random', '--tokenizer', 'stub', '--img-prefix',
            root, '--ann-file', ann, '--result-dir', out,
            '--max-new-tokens', str(KIT_MAX_NEW), '--device', 'cuda'])
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, 'captions_rank0.json')) as f:
            shard = json.load(f)
    keys = ('CIDEr', 'BLEU-1', 'BLEU-4', 'METEOR', 'ROUGE_L')
    ok = (scores['num'] == REGION_CAP_IMAGES and len(shard) ==
          REGION_CAP_IMAGES and all(math.isfinite(scores[k]) for k in keys))
    print(f'region captioning (eval/region_cap CLI, random full-width '
          f'Groma-7B, bf16 Generator): {REGION_CAP_IMAGES} images, '
          f'{KIT_MAX_NEW} tokens a caption, {seconds:.1f} s with the model '
          f'load; shard of {len(shard)} captions, first '
          f'{shard[0]["caption"][:60]!r}; scores '
          + ', '.join(f'{k} {scores[k]:.4f}' for k in keys)
          + f' {"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('region captioning: shard or scores wrong')


def llava_bench_full_width(torch, np, seed: int, card: str):
    """The LLaVA-bench kit at GromaConfig() widths with random weights:
    answer_questions on the first LLAVA_QUESTIONS of the carried questions
    with synthetic images (the bf16 Generator, KIT_MAX_NEW tokens), those
    answers reviewed against a carried model's with the stub judge, then
    review_files over the carried answer files (80 questions) and the
    summary."""
    import os
    import tempfile

    from groma_tpu_torch.checkpoint.loader import load_unquantized
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StubTokenizer
    from groma_tpu_torch.eval import vqa
    from groma_tpu_torch.eval.generate import Generator
    t0 = time.perf_counter()
    model, cfg = load_unquantized('random', device='cuda', seed=seed)
    tok = StubTokenizer(base_vocab=cfg.llm.vocab_size,
                        model_max_length=cfg.max_seq_len)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    table = vqa.TABLE
    with open(os.path.join(table, 'question.jsonl')) as f:
        lines = f.readlines()[:LLAVA_QUESTIONS]
    questions = [json.loads(x) for x in lines]
    samples = [{'image': random_image(np, seed + 90 + i,
                                      cfg.perceiver.image_size),
                'question': q['text'], 'question_id': q['question_id']}
               for i, q in enumerate(questions)]
    answers = vqa.answer_questions(Generator(model, cfg.max_seq_len + 16),
                                   samples, tok, spec,
                                   max_new_tokens=KIT_MAX_NEW)
    seconds = time.perf_counter() - t0
    del model
    judge = vqa.make_judge('stub')
    with tempfile.TemporaryDirectory() as root:
        paths = {}
        for name, rows in (('q', lines), ('ours', [json.dumps(a) + '\n'
                                                   for a in answers])):
            paths[name] = os.path.join(root, f'{name}.jsonl')
            with open(paths[name], 'w') as f:
                f.writelines(rows)
        mine = vqa.review_files(paths['q'], paths['ours'], os.path.join(
            table, 'answer', 'answer_gpt35.jsonl'), judge)
        carried = vqa.review_files(
            os.path.join(table, 'question.jsonl'),
            os.path.join(table, 'answer', 'answer_alpaca-13b.jsonl'),
            os.path.join(table, 'answer', 'answer_vicuna-13b.jsonl'), judge,
            output_path=os.path.join(root, 'review.jsonl'))
    summary = vqa.summarize_reviews(carried)
    ok = (len(answers) == LLAVA_QUESTIONS and all(a['text'] for a in answers)
          and [r['tuple'] for r in mine] == [[5.0, 5.0]] * LLAVA_QUESTIONS
          and len(carried) == 80
          and summary['generic']['relative_score'] == 100.0)
    print(f'LLaVA-bench kit: {LLAVA_QUESTIONS} carried questions answered '
          f'by random full-width Groma-7B (bf16 Generator, {KIT_MAX_NEW} '
          f'tokens) in {seconds:.1f} s with the model load, first answer '
          f'{answers[0]["text"][:60]!r}; stub-judged against gpt35: '
          f'{[r["tuple"] for r in mine]}; review_files over the carried '
          f'answers: {len(carried)} reviews, categories {sorted(summary)} '
          f'{"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('LLaVA-bench kit: answers or reviews wrong')


def _rel_frobenius(a, b) -> float:
    """||a - b|| / ||b|| (0 where both are zero, inf where b alone is)."""
    num, den = (a - b).norm().item(), b.norm().item()
    return num / den if den else (0.0 if num == 0 else math.inf)


def _step_departure(run, ref, start, trained) -> dict:
    """How far ``run``'s step parts from ``ref``'s, both from ``start``:
    the worst trained leaf's gradient and update (after - start) in
    relative Frobenius norm, and the same over all trained leaves as one
    vector."""
    grad, upd, sq = {}, {}, [0.0, 0.0, 0.0, 0.0]
    for k in trained:
        d_run, d_ref = run['after'][k] - start[k], ref['after'][k] - start[k]
        grad[k] = _rel_frobenius(run['grads'][k], ref['grads'][k])
        upd[k] = _rel_frobenius(d_run, d_ref)
        sq[0] += (run['grads'][k] - ref['grads'][k]).norm().item() ** 2
        sq[1] += ref['grads'][k].norm().item() ** 2
        sq[2] += (d_run - d_ref).norm().item() ** 2
        sq[3] += d_ref.norm().item() ** 2
    worst_grad = max(grad.items(), key=lambda kv: kv[1])
    worst_upd = max(upd.items(), key=lambda kv: kv[1])
    return {'grad_leaf': worst_grad, 'update_leaf': worst_upd,
            'grad_all': math.sqrt(sq[0] / sq[1]),
            'update_all': math.sqrt(sq[2] / sq[3])}


def _stage3_two_layers(torch, seed: int):
    """check_stage3's step at full width and 2 LLM layers: (cfg, its B=1
    batch on the card, the stage-3 freeze predicate)."""
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.models.llama import LlamaConfig
    from groma_tpu_torch.train.optimizer import freeze_predicate
    from groma_tpu_torch.train.steps import batch_to
    from groma_tpu_torch.train.synthetic import grounded_batch
    cfg = GromaConfig(llm=LlamaConfig(num_layers=2))
    return (cfg, batch_to(grounded_batch(cfg, 1, seed + 5), 'cuda'),
            freeze_predicate(freeze_perceiver=True, freeze_llm=False))


def _vl_step_run(torch, model, batch, frozen, with_start: bool = False,
                 with_after: bool = True):
    """One train_vl step of ``model`` (sharded as it is to run; use_flash,
    one AdamW step at lr 1e-5, no region permutation) -> {'ms', 'n' (the
    flash launches: bidirectional, causal, causal backward), 'loss',
    'grads' (as the optimizer reads them), 'trained'[, 'after'][,
    'start']}, every tensor whole, in f32 on the CPU; a collective where
    the model is sharded."""
    from groma_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.train.optimizer import make_adamw
    from groma_tpu_torch.train.steps import make_vl_train_step

    def cpu(tree):
        return {k: v.to('cpu', torch.float32, copy=True)
                for k, v in tree.items()}
    opt = make_adamw(model, 1e-5, frozen_pred=frozen)
    run = {'start': cpu(pm.full_model_state(model))} if with_start else {}
    adam_step = opt.opt.step

    def read_grads_then_step(*a, **kw):
        run['grads'] = cpu(pm.full_grads(model))
        return adam_step(*a, **kw)
    opt.opt.step = read_grads_then_step
    step = make_vl_train_step(model, opt, use_flash=True,
                              permute_regions=False)
    for counts in (flash_fwd.launches, flash_bwd.launches):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(batch)
    torch.cuda.synchronize()
    run.update(
        ms=(time.perf_counter() - t0) * 1e3,
        n=(flash_fwd.launches['bidirectional'], flash_fwd.launches['causal'],
           flash_bwd.launches['causal']),
        loss=out['loss'].item(),
        trained=[k for k, p in model.named_parameters() if p.requires_grad])
    if with_after:
        run['after'] = cpu(pm.full_model_state(model))
    return run


def _against_plain(torch, run, plain, again, start, more_controls=None,
                   loss_controls=None, loss_tol: float = FSDP_LOSS_TOL,
                   grad_tol: float = FSDP_GRAD_ALL_TOL,
                   update_tol: float = FSDP_UPDATE_ALL_TOL) -> dict:
    """A step ``run`` against the step without a group (``plain``, and
    ``again`` for its noise) from ``start``: the loss within
    FSDP_LOSS_TOL, the gradients and updates within the FSDP_* limits,
    (``loss_tol``), the gradients and updates over all leaves within
    ``grad_tol`` / ``update_tol`` and each leaf's within the FSDP_*_LEAF
    limits, the frozen leaves bitwise unchanged, the flash
    launches equal, and
    every control missing its limit (no update, the update's sign flipped
    and the gradient halved, made from ``plain``; ``more_controls``,
    {name: a run whose gradient must miss}; ``loss_controls``, {name: a
    run whose loss must miss}; a control that is not finite misses) ->
    {'ok', 'text'}."""
    trained = plain['trained']
    runs = [run, plain, again]
    if not all(r['after'].keys() == start.keys()
               and r['trained'] == trained
               and r['grads'].keys() == set(trained) for r in runs):
        fail('a step\'s parameters are not the plain step\'s')
    still = [k for k in start if k not in trained]
    frozen_ok = all(torch.equal(r['after'][k], start[k])
                    for r in runs for k in still)
    loss_rel = abs(run['loss'] - plain['loss']) / abs(plain['loss'])
    got = _step_departure(run, plain, start, trained)
    noise = _step_departure(again, plain, start, trained)
    no_update = dict(plain, after=start)
    flipped = dict(plain, after={k: 2 * start[k] - plain['after'][k]
                                 for k in trained})
    halved = dict(plain, grads={k: 0.5 * g for k, g in
                                plain['grads'].items()})
    controls = {'no update': _step_departure(no_update, plain, start,
                                             trained)['update_all'],
                'sign flipped': _step_departure(flipped, plain, start,
                                                trained)['update_all'],
                'gradient halved': _step_departure(halved, plain, start,
                                                   trained)['grad_all']}
    limits = {'no update': update_tol, 'sign flipped': update_tol,
              'gradient halved': grad_tol}
    for name, control in (more_controls or {}).items():
        if control['grads'].keys() != set(trained):
            fail(f'the control {name} trains other leaves')
        controls[name] = math.sqrt(
            sum((control['grads'][k] - plain['grads'][k]).norm().item() ** 2
                for k in trained)
            / sum(plain['grads'][k].norm().item() ** 2 for k in trained))
        limits[name] = grad_tol
    for name, control in (loss_controls or {}).items():
        controls[name + ', loss'] = (abs(control['loss'] - plain['loss'])
                                     / abs(plain['loss']))
        limits[name + ', loss'] = loss_tol
    controls_miss = all(not controls[c] <= limits[c] for c in limits)
    within = (got['grad_leaf'][1] <= FSDP_GRAD_LEAF_TOL
              and got['update_leaf'][1] <= FSDP_UPDATE_LEAF_TOL
              and got['grad_all'] <= grad_tol
              and got['update_all'] <= update_tol)

    def said(d):
        return (f'gradients {d["grad_all"]:.2e} over all, worst leaf '
                f'{d["grad_leaf"][1]:.2e} ({d["grad_leaf"][0]}); updates '
                f'{d["update_all"]:.2e} over all, worst leaf '
                f'{d["update_leaf"][1]:.2e} ({d["update_leaf"][0]})')
    ok = (frozen_ok and loss_rel <= loss_tol and within
          and controls_miss and run['n'] == plain['n'] and all(run['n'])
          and math.isfinite(run['loss']))
    text = (f'loss {run["loss"]:.6f} against {plain["loss"]:.6f} without '
            f'the group (rel {loss_rel:.2e}, tol {loss_tol}); '
            f'{len(trained)} trained leaves, relative Frobenius against the '
            f'step without the group: {said(got)} (tol {grad_tol:.3g} '
            f'/ {FSDP_GRAD_LEAF_TOL} and {update_tol:.3g} / '
            f'{FSDP_UPDATE_LEAF_TOL}); that step again, the noise: '
            f'{said(noise)}; {len(still)} frozen leaves unchanged '
            f'{frozen_ok}; controls over all leaves '
            + ', '.join(f'{c} {v:.4g} (limit {limits[c]:.3g})'
                        for c, v in controls.items())
            + f' {"all miss" if controls_miss else "ONE PASSES"}; flash '
            f'launches {run["n"]} (without the group {plain["n"]}); step '
            f'{run["ms"]:.1f} ms against {plain["ms"]:.1f} and '
            f'{again["ms"]:.1f} ms, all cold')
    return {'ok': ok, 'text': text}


def train_vl_fsdp_one_rank(torch, seed: int, card: str):
    """train_vl's step under a 1-rank NCCL process group (init_method a
    file) with FSDP over a (1, 1) mesh (parallel/mesh.shard_model: each
    LLaMA and DINOv2 layer a unit, then the root), stage 3 at full width
    and check_stage3's 2 LLM layers, one AdamW step, against the same step
    on the same weights without a group, run twice: the loss, and each
    trained leaf's gradient (as the optimizer reads it) and update within
    their relative Frobenius limits, alone and over all trained leaves;
    the frozen leaves unchanged.  The second step without a group shows
    the run-to-run noise beside them; three controls made from the step
    without the group (no update, the update's sign flipped, the gradient
    halved) must each miss their limits.  Returns the step's flash
    launches (bidirectional, causal, causal backward)."""
    import os
    import tempfile

    import torch.distributed as dist

    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.parallel import mesh as pm
    cfg, batch, frozen = _stage3_two_layers(torch, seed)
    runs, start = {}, None
    with tempfile.TemporaryDirectory() as root:
        for name in ('fsdp', 'plain', 'plain again'):
            if name == 'fsdp':
                pm.init_distributed('cuda', init_method='file://' + os.path.
                                    join(root, 'group'), num_processes=1,
                                    process_id=0)
            model = random_groma_full(cfg, seed=seed, device='cuda')
            if name == 'fsdp':
                mesh = pm.make_mesh(dp=1, device_type='cuda')
                pm.shard_model(model, mesh)
                sharded = sum(hasattr(p, 'placements')
                              for p in model.parameters())
                n_params = sum(1 for _ in model.parameters())
            runs[name] = _vl_step_run(torch, model, batch, frozen,
                                      with_start=start is None)
            start = start or runs[name].pop('start')
            if name == 'fsdp':
                dist.destroy_process_group()
            del model
            gc.collect()
            torch.cuda.empty_cache()
    fsdp = runs['fsdp']
    j = _against_plain(torch, fsdp, runs['plain'], runs['plain again'],
                       start)
    ok = j['ok'] and sharded == n_params
    print(f'train_vl step under a 1-rank NCCL group, FSDP over a (1, 1) '
          f'mesh (stage 3, full width, 2 LLM layers, B=1): {sharded} '
          f'DTensor parameters; {j["text"]} {"ok" if ok else "FAIL"} '
          f'[{card}]')
    if not ok:
        fail('the FSDP step disagrees with the step without a group')
    return fsdp['n']


# phase 13: tensor parallelism on the one card.  NCCL refuses two ranks on
# one device, so two spawned processes share cuda:0 under a gloo group (the
# tp operators are all-reduces, which gloo carries for CUDA tensors).
# Every time of it is one card time-shared by two ranks over gloo, not a
# multi-card time.
TP = 2
TP_MAX_NEW = 8             # new tokens of the served request (cut from 32)
# Phase 13's limits, fixed from readings on an H100 (80GB HBM3, 700 W),
# each between what the tp run gives and what a fault gives (PERF.md §6
# keeps both readings of each).  A tp run rounds as one process does (each
# product once to bf16, the row-parallel sums in f32), but sums in another
# order, so it parts from the run without a group by more than that run's
# own noise (phase 12's FSDP_* limits), as far as the same step with the
# LLM in f32 shows bf16's rounding itself moves a step (printed beside).
# The forward control leaves reduce-from-tp's all-reduce out (every
# row-parallel product and vocab lookup a rank's partial sum) and must
# miss the loss and prefill limits; the backward control leaves
# copy-to-tp's all-reduce out and must miss the gradient limit.
# The prefill, relative to max|.| of the run without a group: read 1.84e-2
# to 2.05e-2 (last hidden) and 1.62e-2 to 1.81e-2 (first logits); the
# forward control 1.18 to 1.25 and 1.08
TP_HIDDEN_TOL = 0.1
TP_LOGITS_TOL = 0.1
# the step's loss, relative: read 2.0e-5 to 3.19e-5, the forward control
# 1.45e-4 (at random weights the logits are near uniform, so no fault
# moves the loss far: the gradient limits carry the step's check)
TP_LOSS_TOL = 7e-5
# gradients and updates over all trained leaves, relative Frobenius: read
# 8.8e-3 to 1.07e-2 and 9.0e-2 to 9.5e-2 (the controls: the gradient
# halved 0.5, copy-to-tp's all-reduce left out 0.88, the forward control
# 2.22; no update 1.0, the update's sign flipped 2.0); each leaf is held
# to phase 12's limits
TP_GRAD_ALL_TOL = 2e-2
TP_UPDATE_ALL_TOL = 0.2
TP_JOIN_TIMEOUT = 600      # seconds the two ranks may take


def _tp_rank(rank, world, init, job, seed, payload, out_dir):
    """One rank of phase 13, a process spawned on cuda:0: joins the gloo
    group, lays a (1, 1, world) mesh and runs ``job`` ('serve' or
    'train'); writes its result to ``out_dir``/rank{rank}.pt."""
    import os

    import torch
    import torch.distributed as dist

    from groma_tpu_torch.ops import cuda_lib
    from groma_tpu_torch.parallel import mesh as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.library()          # the parent's build, loaded
    pm.init_distributed('cuda', init_method=init, num_processes=world,
                        process_id=rank, backend='gloo')
    mesh = pm.make_mesh(dp=1, tp=world, device_type='cuda')
    torch.cuda.reset_peak_memory_stats()
    out = (_tp_serve_rank if job == 'serve' else _tp_train_rank)(
        torch, mesh, seed, payload, rank)
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def _tp_spawn(torch, job: str, seed: int, payload) -> list:
    """Phase 13's ``job`` on TP spawned ranks -> each rank's result; a rank
    that fails or outlives TP_JOIN_TIMEOUT fails the phase."""
    import multiprocessing
    import os
    import tempfile
    ctx = multiprocessing.get_context('spawn')
    with tempfile.TemporaryDirectory() as root:
        init = 'file://' + os.path.join(root, 'group')
        procs = [ctx.Process(target=_tp_rank, args=(r, TP, init, job, seed,
                                                    payload, root))
                 for r in range(TP)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(TP_JOIN_TIMEOUT)
            if any(p.is_alive() for p in procs):
                fail(f'tp {job}: a rank still runs after {TP_JOIN_TIMEOUT} s')
            if [p.exitcode for p in procs] != [0] * TP:
                fail(f'tp {job}: the ranks exited with '
                     f'{[p.exitcode for p in procs]}')
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(root, f'rank{r}.pt'),
                           weights_only=False) for r in range(TP)]


def _tp_request(np, seed: int):
    """The served request of phase 13 at GromaConfig() widths: a grounded
    stream of max_seq_len (2048) slots, so that the LLM prefill reaches
    FLASH_MIN_SEQ, as phase 6's."""
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.serve.worker import expand_request
    cfg = GromaConfig()
    tok = StableStubTokenizer(cfg.llm.vocab_size, cfg.max_seq_len)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    t = expand_request(tok, spec, {'prompt': SERVED_PROMPTS[0]})
    image = random_image(np, seed + 1, cfg.perceiver.image_size)
    return (image[None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])


def _tp_generate(torch, model, args) -> dict:
    """``Generator(use_flash=True).generate`` of TP_MAX_NEW greedy tokens
    on ``model`` (cut for tp or not), its logits kept at every call of the
    heads (a LogitRecorder: replays record too) and the hidden state the
    prefill's call took -> the tokens, logits, hidden, flash launches,
    the causal flash kernel's q shapes, times and decode mode."""
    from groma_tpu_torch.eval.generate import Generator
    from groma_tpu_torch.models import llama
    from groma_tpu_torch.ops.flash_attention import flash_fwd
    rec = LogitRecorder(torch, TP_MAX_NEW)
    heads, first = model.logits, {}

    def logits(hidden):
        if not first:               # the prefill's call, eager
            first['hidden'] = hidden.float().cpu()
        return rec.wrap(heads)(hidden)
    model.logits = logits
    shapes, flash = [], llama.flash_attention

    def seen(q, *a, **kw):
        shapes.append(tuple(q.shape))
        return flash(q, *a, **kw)
    llama.flash_attention = seen
    gen = Generator(model, max_len=args[1].shape[1] + TP_MAX_NEW,
                    use_flash=True)
    # a gloo tp group's prefill runs eagerly (its collectives go through
    # the host); the reference without a group runs as it does, launch for
    # launch, its hidden state read on the host
    if getattr(model, 'tp_group', None) is None:
        gen._prefills.eager = True
    flash_fwd.launches.update(bidirectional=0, causal=0)
    try:
        toks, _ = gen.generate(*args, max_new_tokens=TP_MAX_NEW)
        torch.cuda.synchronize()
    finally:
        llama.flash_attention = flash
        del model.logits
    st = gen.last_stats
    return {'tokens': [int(t) for t in toks[0]],
            'logits': rec.buf[:, 0].float().cpu(),
            'calls': int(rec.calls), 'hidden': first['hidden'][0],
            'flash': dict(flash_fwd.launches), 'shapes': sorted(set(shapes)),
            'prefill_ms': st['prefill_ms'],
            'decode_ms': st['decode_ms_per_token'],
            'decode_mode': st['decode_mode'],
            'prefill_mode': st['prefill_mode'],
            'finite': st['logits_finite']}


def _tp_prefill_without_reduce(torch, model, args) -> dict:
    """The forward control of phase 13's serving: the prefill alone
    (use_flash) of ``args`` with reduce-from-tp's all-reduce left out ->
    the last hidden state the heads take and the first logits, as
    ``_tp_generate`` keeps them."""
    from groma_tpu_torch.parallel import tensor_parallel
    heads, seen = model.logits, {}

    def logits(hidden):
        seen['hidden'] = hidden.float().cpu()
        return heads(hidden)
    model.logits = logits
    forward = tensor_parallel._ReduceFromTP.forward
    tensor_parallel._ReduceFromTP.forward = staticmethod(
        lambda ctx, x, group: x.clone())
    images, ids, slots, valid = args
    try:
        with torch.no_grad():
            lg, *_ = model.prefill(
                torch.as_tensor(images, dtype=torch.float32, device='cuda'),
                torch.as_tensor(ids, dtype=torch.int64, device='cuda'),
                torch.as_tensor(slots, dtype=torch.int64, device='cuda'),
                torch.as_tensor(valid, dtype=torch.bool, device='cuda'),
                ids.shape[1] + 1, use_flash=True)
            torch.cuda.synchronize()
    finally:
        tensor_parallel._ReduceFromTP.forward = forward
        del model.logits
    return {'hidden': seen['hidden'][0], 'logits': lg[0].float().cpu()}


def _tp_serve_rank(torch, mesh, seed: int, args, rank: int) -> dict:
    """A rank's half of Groma-7B (random weights of ``seed``, the LLM trunk
    in bf16), cut over the tp group, generating for ``args``."""
    from groma_tpu_torch.checkpoint.loader import random_groma_unquantized
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.parallel import mesh as pm
    model = random_groma_unquantized(GromaConfig(), seed=seed, device='cuda')
    pm.shard_model(model, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out = _tp_generate(torch, model, args)
    out['control'] = _tp_prefill_without_reduce(torch, model, args)
    out['cut'] = len(model.tp_plan)
    c = model.cfg.llm
    out['q_heads'] = model.llm.model.layers[0].self_attn.q_proj.weight \
        .shape[0] // (c.hidden_size // c.num_heads)
    return out


def _tp_train_rank(torch, mesh, seed: int, _, rank: int) -> dict:
    """The stage-3 step (2 LLM layers, full width) cut over the tp group,
    then the two controls (their loss and gradients only): the step with
    copy-to-tp's backward all-reduce left out, and with reduce-from-tp's
    forward one left out; each from the random weights of ``seed``.  Rank
    0 returns the three runs; every rank the gradients of the trained
    leaves it holds whole ('replicated'), as the optimizer read them:
    averaged over the tp group, so bitwise the same on both."""
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.parallel import tensor_parallel as tpo
    cfg, batch, frozen = _stage3_two_layers(torch, seed)
    out = {}
    backward, forward = tpo._CopyToTP.backward, tpo._ReduceFromTP.forward
    for name in ('tp', 'backward control', 'forward control'):
        if name == 'backward control':
            tpo._CopyToTP.backward = staticmethod(lambda ctx, g: (g, None))
        if name == 'forward control':
            tpo._ReduceFromTP.forward = staticmethod(
                lambda ctx, x, group: x.clone())
        model = random_groma_full(cfg, seed=seed, device='cuda')
        pm.shard_model(model, mesh)
        try:
            run = _vl_step_run(torch, model, batch, frozen,
                               with_after=name == 'tp')
        finally:
            tpo._CopyToTP.backward = backward
            tpo._ReduceFromTP.forward = forward
        run['cut'] = len(model.tp_plan)
        if name == 'tp':
            out['n'] = run['n']
            out['replicated'] = {k: g for k, g in run['grads'].items()
                                 if k not in model.tp_plan}
        if rank == 0:
            out[name] = run
        del model, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


# the row-parallel product against the f32 GEMM of the same bf16 values,
# relative to max|.|: both sum exact products in f32, in another order
TP_ROW_PRODUCT_TOL = 1e-4


def row_parallel_product(torch, seed: int, card: str):
    """One tp rank's row-parallel ``down_proj`` of the tp prefill (2048 x
    5504 by 5504 -> 4096, bf16, the output f32) as
    ``layers.cast_linear(..., out_dtype=float32)`` runs it on the card
    (one bf16 GEMM that writes f32) against the f32 GEMM of the same
    values (TF32 off): the device times and their difference, within
    TP_ROW_PRODUCT_TOL of max|.|."""
    import torch.nn.functional as F

    from groma_tpu_torch.models.layers import cast_linear
    from groma_tpu_torch.utils.profiling import Timer
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(2048, 5504, generator=gen, device='cuda') \
        .to(torch.bfloat16)
    w = (0.02 * torch.randn(4096, 5504, generator=gen, device='cuda')) \
        .to(torch.bfloat16)
    wide = cast_linear(x, w, out_dtype=torch.float32)
    full = F.linear(x.float(), w.float())
    err = ((wide - full).abs().max() / full.abs().max()).item()
    timer = Timer('cuda')
    ms = timer(lambda: cast_linear(x, w, out_dtype=torch.float32))
    f32_ms = timer(lambda: F.linear(x.float(), w.float()))
    ok = wide.dtype == torch.float32 and err <= TP_ROW_PRODUCT_TOL
    print(f'tp row-parallel product (2048 x 5504 -> 4096, bf16 in, f32 '
          f'out): one bf16 GEMM writing f32 {ms:.4f} ms, the f32 GEMM of '
          f'the same values {f32_ms:.4f} ms (with the casts); rel '
          f'difference {err:.3e} (tol {TP_ROW_PRODUCT_TOL}) '
          f'{"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('the row-parallel product disagrees with its f32 GEMM')


def tensor_parallel_one_card(torch, np, seed: int, card: str) -> dict:
    """Phase 13: tensor parallelism at tp = 2 on two ranks sharing the card
    over gloo.  Serving: Groma-7B at full width (DINOv2-L at 448, 32 LLaMA
    layers, bf16 trunk), unquantized, ``Generator(use_flash=True)``, 8
    greedy tokens of one 2048-slot request, each rank on its 16 query
    heads and half the vocabulary, against the same weights without a
    group: the prefill's last hidden and first logits within
    TP_HIDDEN_TOL / TP_LOGITS_TOL of max|.|, the tokens equal up to a first
    parting at a near tie; each rank 24 launches of #3 and 32 of #4 at (1,
    16, 2048, 128), its decode eager (gloo); the forward control's prefill
    (reduce-from-tp's all-reduce left out) outside both limits.
    Training: the stage-3 step at 2 LLM layers cut over tp (dp = fsdp =
    1) against the step without a group, run twice, and beside the same
    step with the LLM in f32 (what bf16's rounding moves, printed): the
    loss within TP_LOSS_TOL, gradients and updates over all leaves within
    TP_GRAD_ALL_TOL / TP_UPDATE_ALL_TOL and each leaf within phase 12's
    limits, the frozen leaves bitwise, the replicated leaves' gradients
    bitwise equal on both ranks, and five controls missing: phase 12's
    three, the backward control (copy-to-tp's all-reduce left out) the
    gradient limit, the forward control both the loss and the gradient
    limits.  Returns the launches of the ranks' main runs, summed:
    {'bidirectional', 'causal', 'causal backward'}."""
    from groma_tpu_torch.checkpoint.loader import (random_groma_full,
                                                   random_groma_unquantized)
    from groma_tpu_torch.models import llama
    from groma_tpu_torch.models.groma import GromaConfig
    from groma_tpu_torch.models.llama import FLASH_MIN_SEQ
    row_parallel_product(torch, seed, card)
    args = _tp_request(np, seed)
    s = args[1].shape[1]
    if s < FLASH_MIN_SEQ:
        fail(f'tp serving: a {s}-slot stream runs no causal flash kernel')

    t0 = time.perf_counter()
    model = random_groma_unquantized(GromaConfig(), seed=seed, device='cuda')
    ref = _tp_generate(torch, model, args)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = _tp_spawn(torch, 'serve', seed, args)
    t2 = time.perf_counter()
    problems = []
    for r, got in enumerate(ranks):
        hid = ((got['hidden'] - ref['hidden']).abs().max()
               / ref['hidden'].abs().max()).item()
        first = ((got['logits'][0] - ref['logits'][0]).abs().max()
                 / ref['logits'][0].abs().max()).item()
        j = _first_difference(ref['tokens'], got['tokens'])
        parted = 'none'
        if j < TP_MAX_NEW:
            gap, diff, tie = _parted_at_near_tie(
                ref['logits'][j], got['logits'][j], ref['tokens'][j],
                got['tokens'][j],
                TP_LOGITS_TOL * ref['logits'][j].abs().max().item())
            parted = (f'at token {j}, top-2 gap {gap:.4f} under the logits\' '
                      f'difference {diff:.4f}: near tie {tie}')
            if not tie:
                problems.append(f'rank {r} parted from the tokens without '
                                f'a group at token {j} off a near tie')
        launches = (got['flash']['bidirectional'], got['flash']['causal'])
        print(f'tp serving rank {r} of {TP}: {got["cut"]} parameters cut, '
              f'{got["q_heads"]} query heads a layer; prefill hidden rel '
              f'{hid:.3e} (tol {TP_HIDDEN_TOL}), first logits rel '
              f'{first:.3e} (tol {TP_LOGITS_TOL}) against the same weights '
              f'without a group; tokens {got["tokens"]} (without the group '
              f'{ref["tokens"]}), first parting {parted}; flash launches '
              f'#3 {launches[0]}, #4 {launches[1]} at {got["shapes"]}; '
              f'decode {got["decode_mode"]}; prefill {got["prefill_mode"]} '
              f'(a gloo group\'s), {got["prefill_ms"]:.1f} ms, decode '
              f'{got["decode_ms"]:.2f} ms/token, peak '
              f'{got["peak_gib"]:.2f} GiB (one card time-shared by two '
              f'ranks over gloo, not a multi-card time) [{card}]')
        ctl = got['control']
        ctl_hid = ((ctl['hidden'] - ref['hidden']).abs().max()
                   / ref['hidden'].abs().max()).item()
        ctl_first = ((ctl['logits'] - ref['logits'][0]).abs().max()
                     / ref['logits'][0].abs().max()).item()
        # a control that is not finite misses
        ctl_miss = not (ctl_hid <= TP_HIDDEN_TOL
                        or ctl_first <= TP_LOGITS_TOL)
        print(f'tp serving rank {r}, the forward control (reduce-from-tp\'s '
              f'all-reduce left out): prefill hidden rel {ctl_hid:.3e}, '
              f'first logits rel {ctl_first:.3e}: '
              f'{"both miss" if ctl_miss else "ONE PASSES"} [{card}]')
        if hid > TP_HIDDEN_TOL or first > TP_LOGITS_TOL:
            problems.append(f'rank {r}: prefill outside its limits')
        if not ctl_miss:
            problems.append(f'rank {r}: the forward control passes a '
                            f'prefill limit')
        if launches != (24, 32) or got['shapes'] != [(1, 32 // TP, s, 128)]:
            problems.append(f'rank {r}: flash launches {launches} at '
                            f'{got["shapes"]}')
        if got['decode_mode'] != 'eager: gloo tp group' or not got['finite'] \
                or got['calls'] != TP_MAX_NEW \
                or got['prefill_mode'] != 'eager':
            problems.append(f'rank {r}: decode {got["decode_mode"]}, prefill '
                            f'{got["prefill_mode"]}, finite '
                            f'{got["finite"]}, {got["calls"]} head calls')
        if got['tokens'] != ranks[0]['tokens']:
            problems.append('the ranks\' tokens differ')
    print(f'tp serving without a group (Generator, captured decode): '
          f'prefill ({ref["prefill_mode"]}, as the ranks\') '
          f'{ref["prefill_ms"]:.1f} ms, decode {ref["decode_ms"]:.2f} '
          f'ms/token, flash launches {ref["flash"]}, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB of the '
          f'script; reference {t1 - t0:.1f} s, the two ranks {t2 - t1:.1f} s '
          f'with their start [{card}]')
    if problems:
        fail('tp serving: ' + '; '.join(problems))

    cfg, batch, frozen = _stage3_two_layers(torch, seed)
    plain = {}
    for name in ('plain', 'plain again', 'f32'):
        # 'f32': the LLM in f32 (its attention dense: the flash kernels
        # take bf16), the yardstick of what bf16's rounding moves
        model = random_groma_full(
            cfg.replace(llm=cfg.llm.replace(dtype='float32'))
            if name == 'f32' else cfg, seed=seed, device='cuda')
        flash_min = llama.FLASH_MIN_SEQ
        if name == 'f32':
            llama.FLASH_MIN_SEQ = 1 << 30
        try:
            plain[name] = _vl_step_run(torch, model, batch, frozen,
                                       with_start=not plain)
        finally:
            llama.FLASH_MIN_SEQ = flash_min
        del model
        gc.collect()
        torch.cuda.empty_cache()
    start = plain['plain'].pop('start')
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    ranks_t = _tp_spawn(torch, 'train', seed, None)
    t4 = time.perf_counter()
    tp = ranks_t[0]['tp']
    f32 = plain['f32']
    trained = plain['plain']['trained']
    bf16 = _step_departure(plain['plain'], f32, start, trained)
    tp_f32 = _step_departure(tp, f32, start, trained)
    print(f'tp step beside the step with the LLM in f32 (dense attention): '
          f'the plain bf16 step parts from it by {bf16["grad_all"]:.3e} '
          f'(gradients over all) and {bf16["update_all"]:.3e} (updates), '
          f'the tp step by {tp_f32["grad_all"]:.3e} and '
          f'{tp_f32["update_all"]:.3e}; its loss {f32["loss"]:.6f} '
          f'[{card}]')
    fwd = ranks_t[0]['forward control']
    j = _against_plain(torch, tp, plain['plain'], plain['plain again'],
                       start,
                       {'backward control': ranks_t[0]['backward control'],
                        'forward control': fwd},
                       {'forward control': fwd}, loss_tol=TP_LOSS_TOL,
                       grad_tol=TP_GRAD_ALL_TOL,
                       update_tol=TP_UPDATE_ALL_TOL)
    mine, theirs = ranks_t[0]['replicated'], ranks_t[1]['replicated']
    replica = mine.keys() == theirs.keys() and all(
        torch.equal(g, theirs[k]) for k, g in mine.items())
    ok = j['ok'] and tp['cut'] > 0 and replica
    print(f'train_vl step at tp={TP} on two ranks of the card over gloo '
          f'(stage 3, full width, 2 LLM layers, B=1): {tp["cut"]} parameters '
          f'cut; the {len(mine)} trained leaves each rank holds whole: their '
          f'gradients, averaged over the ranks, bitwise equal on both '
          f'{replica}; {j["text"]}; '
          f'peak {", ".join(f"{r["peak_gib"]:.2f}" for r in ranks_t)} GiB a '
          f'rank (one card time-shared by two ranks over gloo, not a '
          f'multi-card time); the two ranks {t4 - t3:.1f} s with their '
          f'start {"ok" if ok else "FAIL"} [{card}]')
    if not ok:
        fail('the tp step disagrees with the step without a group')
    return {'bidirectional': sum(r['flash']['bidirectional'] for r in ranks)
            + sum(r['n'][0] for r in ranks_t),
            'causal': sum(r['flash']['causal'] for r in ranks)
            + sum(r['n'][1] for r in ranks_t),
            'causal backward': sum(r['n'][2] for r in ranks_t)}


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
    int8_decode, _, int8_prefill = check_int8_matmul(torch, gen, timer,
                                                     card)
    check_w8a8_matmul(torch, gen, timer, card)
    check_w8a8_conv(torch, gen, timer, card)
    att_err, att_ms, att_bound = check_decode_attention(torch, gen, timer,
                                                        card)
    int4_decode, int4_prefill = check_int4_matmul(torch, gen, timer, card)
    gqa_mm = check_gqa_qkv_matmuls(torch, gen, timer, card)
    paged_err, paged_ms, paged_plain_ms, paged_bound = check_paged_attention(
        torch, gen, timer, card)
    flash = check_flash(torch, gen, timer, card)
    check_decode_megakernel(torch, gen, timer, args.seed, card)
    probes = check_probes(torch, timer, args.seed, card)
    del timer
    check_llm_path(torch, args.seed, card)
    check_int4_paged_path(torch, args.seed, card)
    check_gqa_llm_path(torch, args.seed, card)
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
    giant_n, giant_flash = dinov2_giant_forward(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    (mm_n, mm_pre_n, att_n), worker = serve_full_width(torch, np, args.seed,
                                                        card)
    if not (mm_n - mm_pre_n and mm_pre_n and att_n):
        fail('a kernel of the served path was never launched')
    serve_w8a8_and_speculation(torch, np, worker, args.seed, card)
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    check_bf16_llm_path(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    if not all(serve_unquantized_full_width(torch, np, args.seed, card)):
        fail('a flash kernel of the unquantized prefill was never launched')
    gc.collect()
    torch.cuda.empty_cache()
    int4_n, paged_n, int4_prefill_n = serve_engine_full_width(
        torch, np, args.seed, card)
    if not (int4_n and paged_n and int4_prefill_n):
        fail('a kernel of the engine path was never launched')
    gc.collect()
    torch.cuda.empty_cache()
    gqa_n = serve_gqa_full_width(torch, np, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    if not all(serve_stack_full_width(torch, np, args.seed, card)):
        fail('a kernel of the serving stack was never launched')
    gc.collect()
    torch.cuda.empty_cache()
    mk_n, mk_times = decode_megakernel_path(torch, Timer('cuda'),
                                            args.seed, card)
    if not mk_n:
        fail('the decode megakernel was never launched on its path')
    gc.collect()
    torch.cuda.empty_cache()
    probe_n = probes_main_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_det_full_width(torch, np, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    region_caption_full_width(torch, np, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    llava_bench_full_width(torch, np, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_vl_fsdp_one_rank(torch, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    tp_n = tensor_parallel_one_card(torch, np, args.seed, card)
    if not (tp_n['causal'] and tp_n['causal backward']):
        fail('a flash kernel of the tp path was never launched')
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
        entry('int8_matmul (decode tile, M < 256)', 'int8_matmul.cu',
              'groma_tpu/ops/quant.py:52', mm_n - mm_pre_n, int8_decode[0],
              *int8_decode[1], *int8_decode[2:]),
        entry('int8_matmul (prefill tile, M >= 256)', 'int8_matmul.cu',
              'groma_tpu/ops/quant.py:52', mm_pre_n, int8_prefill[0],
              *int8_prefill[1], *int8_prefill[2:]),
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
              int4_n, int4_decode[0], *int4_decode[1], *int4_decode[2:]),
        entry('int4_matmul (prefill tile, M > 8)', 'int4_matmul.cu',
              'groma_tpu/ops/quant4.py:85', int4_prefill_n, int4_prefill[0],
              *int4_prefill[1], *int4_prefill[2:]),
        entry('paged_int8_decode_attention', 'paged_attention.cu',
              'groma_tpu/ops/paged_attention.py:51', paged_n, paged_err,
              paged_ms, paged_plain_ms, paged_bound, None),
        entry('decode_megakernel', 'decode_megakernel.cu',
              'groma_tpu/ops/decode_megakernel.py:192', mk_n, *mk_times[:3],
              mk_times[3:], None),
        flash_entry('flash_bwd (bidirectional)', 'bidirectional backward',
                    'flash_attention_bwd.cu',
                    'groma_tpu/ops/flash_attention.py:453', vit_bwd_n),
        entry('int8_matmul (decode tile, all of GQA serving\'s launches; '
              'timed at the qkv N=6144, M=1)',
              'int8_matmul.cu', 'groma_tpu/ops/quant.py:52', gqa_n['int8'][0],
              gqa_mm[('int8', 1)][0], *gqa_mm[('int8', 1)][1],
              *gqa_mm[('int8', 1)][2:]),
        entry('int8_matmul (prefill tile, all of GQA serving\'s launches; '
              'timed at the qkv N=6144, M=2048)', 'int8_matmul.cu',
              'groma_tpu/ops/quant.py:52',
              gqa_n['int8'][1], gqa_mm[('int8', 2048)][0],
              *gqa_mm[('int8', 2048)][1], *gqa_mm[('int8', 2048)][2:]),
        entry('int4_matmul (decode tile, all of the GQA engine\'s launches; '
              'timed at the qkv N=6144, M=8)',
              'int4_matmul.cu', 'groma_tpu/ops/quant4.py:85',
              gqa_n['int4'][0], gqa_mm[('int4', 8)][0],
              *gqa_mm[('int4', 8)][1], *gqa_mm[('int4', 8)][2:]),
        entry('int4_matmul (prefill tile, all of the GQA engine\'s launches; '
              'timed at the qkv N=6144, M=2048)', 'int4_matmul.cu',
              'groma_tpu/ops/quant4.py:85',
              gqa_n['int4'][1], gqa_mm[('int4', 2048)][0],
              *gqa_mm[('int4', 2048)][1], *gqa_mm[('int4', 2048)][2:]),
        flash_entry(f'flash_fwd (causal, tp={TP} local heads (1, '
                    f'{32 // TP}, 2048, 128); launches of both ranks)',
                    'causal_tp', 'flash_attention_fwd.cu',
                    'groma_tpu/ops/flash_attention.py:222', tp_n['causal']),
        flash_entry(f'flash_bwd (causal, tp={TP} local heads (1, '
                    f'{32 // TP}, 2048, 128); launches of both ranks)',
                    'backward_tp', 'flash_attention_bwd.cu',
                    'groma_tpu/ops/flash_attention.py:527',
                    tp_n['causal backward']),
        entry('flash_fwd (bidirectional, DINOv2-giant (1, 24, 1025, 64))',
              'flash_attention_fwd.cu', 'groma_tpu/ops/flash_attention.py:68',
              giant_n, giant_flash[0], *giant_flash[1], *giant_flash[2:]),
        *[entry(f'{name} ({key})', source, replaces, probe_n[key],
                *probes[key][:3], probes[key][3], probes[key][4])
          for key, name, source, replaces in PROBE_KERNELS],
    ]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
