"""The whole L-layer int4 + int8-KV decode step in one launch.

Counterpart of ``groma_tpu/ops/decode_megakernel.py``.  ``fused_decode_step``
replaces the TPU kernel ``_make_kernel`` (one ``pallas_call`` with
``grid=(L,)``) with the hand-written cooperative CUDA kernel in
``csrc/decode_megakernel.cu``: every layer's rms-norm, fused qkv, RoPE,
int8 cache write, attention over the int8 cache, o-projection, rms-norm,
gate/up, SiLU and down-projection, with the f32 residual carried across the
layers, in a single launch.  The cache is updated in place at the scalar
position ``pos``, which the kernel reads from a 0-d int32 device word when
it runs, so a CUDA graph that captures the launch writes at the slot the
word holds at each replay.

The stacked forms are the port's own.  The kernel takes a device table of
per-layer addresses, so neither the weights nor the cache are copied:

* ``stack_decode_params(qp)`` keeps the per-layer int4 tensors of
  ``llama_quant.quantize_llama_params(bits=4)`` under the JAX package's keys
  (``wqkv``, ``sqkv``, ... as lists of L tensors), the two norm scales
  stacked as (L, D) f32, and, on CUDA, ``table``: (L, 8) int64 addresses,
  ``maps``: the TMA maps of the packed weights (L x 4 x 128 bytes, encoded
  once), and ``plan``: the kernel's work plan for the card's SMs
  (``megakernel_plan`` over ``ctas`` CTAs, with the workspace it needs).
* ``stack_kv_cache(cache)`` shares the per-layer (B, H, S, 128) int8 and
  (B, H, S) f32 buffers of ``llama_quant.make_quant_kv_cache``, keeps the
  index as a 0-d int32 tensor on the cache's device, and adds, on CUDA,
  ``table``: (L, 4) int64 addresses.  ``unstack_kv_cache`` is its
  inverse.
* Both keep ``ptrs``, the host-side tuple of the addresses they were
  stacked from; ``fused_decode_step`` raises if a list entry has since been
  replaced, since the kernel would read the freed buffer through the
  table.  None of the TPU layout's padding (8-row scale blocks), its
  (L, H, B, S) scale transpose or its aligned-tile column write carries
  over.

The work plan: each matmul's (128-column tile, 64-row box) units, tiles
outer, cut into one contiguous range a CTA (every CTA within one box of
the others; a gate tile and its up tile one unit), a range that covers
part of a tile a split-K segment.

Numerics are the TPU megakernel's, not the per-layer path's: the residual
stays f32 across layers, RoPE acts on the f32 qkv, each rms-norm rounds to
bf16, attention output and SiLU product are rounded to bf16 before their
matmuls, and q, k and v are quantized per (b, head) with IEEE division by
127.  The int4 products follow the TPU kernel's order: a 256-row block's
dot on the exact integer weights with f32 sums, times the block's scale
after the dot.  The plain version computes it as ``_int4_chunk_dot`` does
(biased nibbles, ``x@n - 8*sum(x)`` per block, then the scale), the CUDA
kernel on the tensor cores with the nibbles unbiased before the product,
split over K and over the warps of a CTA; the two differ in f32 rounding
only.  The current token joins the softmax max, denominator and p
requantization in registers, and its p8*v term joins the int32 sum before
the f32 cast.  Attention reads the cache as it was before this step's
column is written.

* ``fused_decode_step_plain`` is the plain PyTorch version, on any device.
* ``fused_decode_step`` takes the plain version only for CPU tensors.  On
  CUDA tensors it launches the kernel or raises.  A host ``pos`` outside
  the cache raises on both (JAX clamps the write); a device word is the
  caller's to keep inside, checked once per run.
  ``fused_decode_step.launches`` counts launches; a launch leaves its grid, its grid barriers a step and its
  dynamic shared memory in ``.blocks``, ``.barriers`` and ``.smem``.
* ``phase_stamps`` launches once with per-block ``%globaltimer`` stamps at
  every phase and barrier; ``phase_split`` turns them into ms of work, idle
  tail and barrier wait per phase.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from groma_tpu_torch.ops.quant import true_div

HEAD_DIM = 128
INT4_BLOCK = 256
MAX_BATCH = 8        # the kernel's matmul tile holds 8 rows
_MATMULS = (('wqkv', 'sqkv', 'qkv_proj'), ('wo', 'so', 'o_proj'),
            ('wgu', 'sgu', 'gate_up_proj'), ('wdn', 'sdn', 'down_proj'))


def _addresses(form: dict, keys) -> tuple:
    return tuple(t.data_ptr() for k in keys for t in form[k])


def _address_table(rows, device) -> torch.Tensor:
    return torch.tensor([[t.data_ptr() for t in row] for row in rows],
                        dtype=torch.int64).to(device)


_PARAM_KEYS = tuple(k for wk, sk, _ in _MATMULS for k in (wk, sk))
_CACHE_KEYS = ('k', 'k_scale', 'v', 'v_scale')


def stack_decode_params(qp: dict, ctas: int | None = None) -> dict:
    """Per-layer int4 tree (``quantize_llama_params(bits=4)``) -> the
    megakernel's form: the same weight tensors (no copy) as lists under the
    JAX package's keys, the norm scales as (L, D) f32, and on CUDA an (L, 8)
    table of the weights' addresses, their TMA maps (``maps``, L x 4 x 128
    bytes) and the kernel's work plan (``plan``, ``megakernel_plan`` as
    int32) over ``ctas`` CTAs, by default one per SM of the card."""
    layers = qp['layers']
    for lp in layers:
        for _, _, name in _MATMULS:
            if lp[name]['q'].dtype != torch.uint8:
                raise ValueError('the megakernel takes the packed-int4 tree '
                                 '(bits=4)')
    sp = {'ln1': torch.stack([lp['input_layernorm'].float()
                              for lp in layers]).contiguous(),
          'ln2': torch.stack([lp['post_attention_layernorm'].float()
                              for lp in layers]).contiguous()}
    for wk, sk, name in _MATMULS:
        sp[wk] = [lp[name]['q'].contiguous() for lp in layers]
        sp[sk] = [lp[name]['scale'].contiguous() for lp in layers]
    dev = sp['ln1'].device
    sp['table'] = sp['maps'] = sp['plan'] = None
    if dev.type == 'cuda':
        sp['table'] = _address_table(
            [[sp[k][i] for k in _PARAM_KEYS] for i in range(len(layers))],
            dev)
        sp['maps'] = _tensor_maps(sp, dev)
        sp['ctas'] = ctas or torch.cuda.get_device_properties(
            dev).multi_processor_count
        d, f = sp['ln1'].shape[1], sp['wdn'][0].shape[0] * 2
        plan = megakernel_plan(d, f, sp['ctas'])
        sp['plan'] = _plan_tensor(plan, dev)
        # the workspace: x's sums of squares by column tile, every
        # segment's partial (a pair's two); the barrier's word and a
        # counter per column tile
        mats = megakernel_matrices(d, f)
        sp['work_floats'] = (d // TILE_COLS + max(
            sum(map(len, per_cta)) * (2 if paired else 1)
            for per_cta, (_, _, paired) in zip(plan, mats)) * TILE_COLS) \
            * MAX_BATCH
        sp['sync_words'] = 1 + max(n // TILE_COLS for _, n, _ in mats)
    sp['ptrs'] = _addresses(sp, _PARAM_KEYS)
    return sp


def _tensor_maps(sp: dict, device) -> torch.Tensor:
    """The TMA maps of every layer's four packed weights, on ``device``."""
    from groma_tpu_torch.ops.cuda_lib import check, library
    n_layers = len(sp['wqkv'])
    d, f = sp['ln1'].shape[1], sp['wdn'][0].shape[0] * 2
    ptrs = torch.tensor([[sp[k][i].data_ptr() for k, _, _ in _MATMULS]
                         for i in range(n_layers)], dtype=torch.int64)
    host = torch.empty(n_layers * len(_MATMULS) * 128, dtype=torch.uint8)
    check(library().groma_decode_megakernel_maps(
        host.data_ptr(), ptrs.data_ptr(), n_layers, d, f),
        'decode_megakernel maps')
    return host.to(device)


# ---------------------------------------------------------- the work plan

BOX_ROWS = 64        # packed rows of a weight box, one stage of the ring
TILE_COLS = 128      # columns of a weight box and of an output tile
PHASES = ('qkv', 'attention', 'o_proj', 'gate_up', 'down')
_SEG_INTS = 8


def megakernel_matrices(d: int, f: int) -> tuple:
    """(K, N, paired) of a layer's four matmuls in phase order; ``paired``:
    the columns are [gate | up], and gate tile j and up tile F/128 + j are
    one tile pair."""
    return ((d, 3 * d, False), (d, d, False), (d, 2 * f, True),
            (f, d, False))


def megakernel_plan(d: int, f: int, ctas: int) -> list:
    """The kernel's matmul work on ``ctas`` CTAs, one list per matrix of
    ``megakernel_matrices``, of one list per CTA of its segments (tile,
    box0, box1, split, splits, slot): boxes [box0, box1) (of BOX_ROWS
    packed rows) of column tile (or tile pair) ``tile``, split ``split`` of
    the tile's ``splits``, its f32 partial at workspace slot ``slot``.  The
    (tile, box) units, tiles outer, are cut into one contiguous range a CTA
    of floor or ceil of units / ctas: every CTA streams the same bytes to
    within one box (a pair's unit is its gate and its up box).  A tile's
    splits are consecutive slots."""
    out = []
    for k, n, paired in megakernel_matrices(d, f):
        boxes = k // 2 // BOX_ROWS
        tiles = n // TILE_COLS // (2 if paired else 1)
        units = tiles * boxes
        per_cta, flat = [], []
        for c in range(ctas):
            mine, u, hi = [], units * c // ctas, units * (c + 1) // ctas
            while u < hi:
                t = u // boxes
                end = min(hi, (t + 1) * boxes)
                mine.append([t, u - t * boxes, end - t * boxes])
                u = end
            per_cta.append(mine)
            flat.extend(mine)
        splits = {}
        for seg in flat:
            splits[seg[0]] = splits.get(seg[0], 0) + 1
        seen = {}
        for slot, seg in enumerate(flat):
            seg += [seen.get(seg[0], 0), splits[seg[0]], slot]
            seen[seg[0]] = seg[3] + 1
        out.append([[tuple(seg) for seg in mine] for mine in per_cta])
    return out


def _plan_tensor(plan: list, device) -> torch.Tensor:
    """``megakernel_plan`` as the kernel reads it: for each matrix the
    first segment of every CTA and the end (absolute indices), then the
    segments, _SEG_INTS ints each."""
    offsets, segs = [], []
    for per_cta in plan:
        for mine in per_cta:
            offsets.append(len(segs))
            segs.extend(mine)
        offsets.append(len(segs))
    flat = offsets + [v for seg in segs
                      for v in seg + (0,) * (_SEG_INTS - len(seg))]
    return torch.tensor(flat, dtype=torch.int32).to(device)


def stack_kv_cache(cache: dict) -> dict:
    """Per-layer int8 cache (``make_quant_kv_cache``) -> the megakernel's
    form: the same buffers (no copy; the kernel writes them in place), and
    on CUDA an (L, 4) table of their addresses (k, k_scale, v, v_scale)."""
    st = {k: cache[k] for k in ('k', 'k_scale', 'v', 'v_scale', 'mask')}
    dev = st['k'][0].device
    index = cache['index']
    st['index'] = index.to(torch.int32) if torch.is_tensor(index) \
        else torch.full((), index, dtype=torch.int32, device=dev)
    st['table'] = _address_table(
        [[st[k][i] for k in _CACHE_KEYS] for i in range(len(st['k']))],
        dev) if dev.type == 'cuda' else None
    st['ptrs'] = _addresses(st, _CACHE_KEYS)
    return st


def unstack_kv_cache(st: dict, num_layers: int) -> dict:
    """Inverse of ``stack_kv_cache``: the per-layer cache over the same
    buffers."""
    if len(st['k']) != num_layers:
        raise ValueError(f'{len(st["k"])} layers in the cache, not '
                         f'{num_layers}')
    return {'k': list(st['k']), 'v': list(st['v']),
            'k_scale': list(st['k_scale']), 'v_scale': list(st['v_scale']),
            'mask': st['mask'], 'index': st['index']}


def supported(cfg, batch: int, qp: dict) -> bool:
    """The geometry the kernel takes: MHA with 128-wide heads, the
    packed-int4 tree, K dimensions in whole 256-row scale blocks, at most
    MAX_BATCH rows."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    try:
        int4 = qp['layers'][0]['qkv_proj']['q'].dtype == torch.uint8
    except (KeyError, IndexError):
        return False
    return (int4 and cfg.num_heads == cfg.num_kv_heads
            and d == cfg.num_heads * HEAD_DIM and d % INT4_BLOCK == 0
            and f % INT4_BLOCK == 0 and 1 <= batch <= MAX_BATCH)


# --------------------------------------------------------- plain version

def _int4_chunk_dot(x_bf, packed, scale):
    """(M, K) bf16 @ packed int4 (K/2, N) with (K/256, N) scales, the TPU
    kernel's algebra: the biased nibbles' f32 dot per 256-row K block,
    minus 8 times the block's x sum, times the block's scales, summed over
    the blocks in order."""
    m, k = x_bf.shape
    p = packed.to(torch.int32)
    nib = torch.cat([p & 0xF, p >> 4], 0).to(torch.float32)   # (K, N)
    nblk = k // INT4_BLOCK
    xb = x_bf.to(torch.float32).reshape(m, nblk, INT4_BLOCK).transpose(0, 1)
    part = torch.bmm(xb, nib.reshape(nblk, INT4_BLOCK, -1))   # (nblk, M, N)
    xsum = xb.sum(-1, keepdim=True)
    acc = torch.zeros_like(part[0])
    for b in range(nblk):
        acc = acc + (part[b] - 8.0 * xsum[b]) * scale[b]
    return acc


def _rms(x32, scale_row, eps):
    """(M, D) f32 -> bf16-rounded rms-norm."""
    v = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (v * scale_row).to(torch.bfloat16)


def _rope(x32, cos, sin):
    """(B, H, hd) f32 half-rotation by (B, hd) tables."""
    half = x32.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return x32 * cos[:, None] + rot * sin[:, None]


def _quant_rows(x32):
    """Symmetric per-row absmax int8 over the last dim (IEEE division)."""
    a = x32.abs().amax(-1, keepdim=True)
    s = torch.where(a > 0, true_div(a, 127.0), torch.ones_like(a))
    return torch.clamp(torch.round(x32 / s), -127, 127), s


def _attend(q, k, v, k8, ks, v8, vs, mask_bias, cur_bias, scale):
    """One layer's attention for every (b, head): the old cache positions
    (bias ``mask_bias``) plus the current token (``cur_bias``) folded in.
    q/k/v (B, H, hd) f32 (roped) -> (attn (B, H, hd) f32, the current
    token's int8 k and v (as floats) and their (B, H, 1) scales)."""
    q8, qs = _quant_rows(q)
    k8c, ksc = _quant_rows(k)
    v8c, vsc = _quant_rows(v)
    qsc = qs * scale
    s_old = torch.einsum('bhd,bhsd->bhs', q8.double(),
                         k8.double()).float()
    s_old = s_old * qsc * ks + mask_bias[:, None, :]
    s_cur = (q8.double() * k8c.double()).sum(-1, keepdim=True).float()
    s_cur = s_cur * qsc * ksc + cur_bias[:, None, :]
    m = torch.maximum(s_old.amax(-1, keepdim=True), s_cur)
    p_old = torch.exp(s_old - m)
    p_cur = torch.exp(s_cur - m)
    denom = p_old.sum(-1, keepdim=True) + p_cur
    ps_old = p_old * vs
    ps_cur = p_cur * vsc
    r = torch.maximum(ps_old.amax(-1, keepdim=True), ps_cur)
    r = torch.where(r > 0, true_div(r, 127.0), torch.ones_like(r))
    p8 = torch.round(ps_old / r)
    p8c = torch.round(ps_cur / r)
    o = torch.einsum('bhs,bhsd->bhd', p8.double(), v8.double())
    o = o + p8c.double() * v8c.double()
    attn = o.float() * (r / torch.clamp(denom, min=1e-30))
    return attn, k8c, ksc, v8c, vsc


def _slot(pos, device) -> torch.Tensor:
    """A host int or 0-d device word -> the (1,) int64 index of its slot."""
    if torch.is_tensor(pos):
        return pos.long().view(1)
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def fused_decode_step_plain(sp: dict, x, kv: dict, mask_bias, cur_bias,
                            cos, sin, pos, eps: float = 1e-5):
    """The plain PyTorch version of ``fused_decode_step``, on any device;
    ``kv``'s buffers are updated in place at ``pos`` (a host int or a 0-d
    device word)."""
    at = _slot(pos, x.device)
    b, d = x.shape
    h = d // HEAD_DIM
    scale = HEAD_DIM ** -0.5
    x = x.to(torch.float32)
    mask_bias = mask_bias.to(torch.float32)
    cur_bias = cur_bias.to(torch.float32).reshape(b, 1)
    cos, sin = cos.to(torch.float32), sin.to(torch.float32)
    for i in range(len(sp['wqkv'])):
        h1 = _rms(x, sp['ln1'][i], eps)
        qkv = _int4_chunk_dot(h1, sp['wqkv'][i], sp['sqkv'][i])
        q, k, v = (t.reshape(b, h, HEAD_DIM) for t in qkv.split(d, dim=-1))
        attn, k8c, ksc, v8c, vsc = _attend(
            _rope(q, cos, sin), _rope(k, cos, sin), v, kv['k'][i],
            kv['k_scale'][i], kv['v'][i], kv['v_scale'][i], mask_bias,
            cur_bias, scale)
        kv['k'][i].index_copy_(2, at, k8c.to(torch.int8)[:, :, None])
        kv['v'][i].index_copy_(2, at, v8c.to(torch.int8)[:, :, None])
        kv['k_scale'][i].index_copy_(2, at, ksc)
        kv['v_scale'][i].index_copy_(2, at, vsc)
        x = x + _int4_chunk_dot(attn.reshape(b, d).to(torch.bfloat16),
                                sp['wo'][i], sp['so'][i])
        h2 = _rms(x, sp['ln2'][i], eps)
        gate, up = _int4_chunk_dot(h2, sp['wgu'][i],
                                   sp['sgu'][i]).chunk(2, dim=-1)
        act = (F.silu(gate) * up).to(torch.bfloat16)
        x = x + _int4_chunk_dot(act, sp['wdn'][i], sp['sdn'][i])
    return x


# --------------------------------------------------------------- wrapper

# (device, stream) -> (f32 split-K partials, uint32 sync words)
_workspaces = {}


def _workspace(device, floats: int, words: int):
    """The split-K workspace and the barrier and tile-counter words of
    the current stream of ``device``: the words zeroed once and left at
    zero (count) or advancing (generation) by every launch, so launches
    share them only in stream order; launches on two streams, which may
    overlap, never share them.  Grown (and zeroed) when a plan needs more,
    in the stream that uses them."""
    stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream)
    work, sync = _workspaces.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty(floats, dtype=torch.float32, device=device)
    if sync is None or sync.numel() < words:
        sync = torch.zeros(words, dtype=torch.int32, device=device)
    _workspaces[key] = (work, sync)
    return work, sync


def _launch(sp, x, kv, mask_bias, cur_bias, cos, sin, pos, eps,
            stamps=None):
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    b, d = x.shape
    n_layers = len(sp['wqkv'])
    f = sp['wdn'][0].shape[0] * 2
    h, s = d // HEAD_DIM, kv['k'][0].shape[2]
    out = torch.empty_like(x)
    qkv = torch.empty((b, 3 * d), dtype=torch.float32, device=x.device)
    attn = torch.empty((b, d), dtype=torch.bfloat16, device=x.device)
    act = torch.empty((b, f), dtype=torch.bfloat16, device=x.device)
    work, sync = _workspace(x.device, sp['work_floats'], sp['sync_words'])
    info = (ctypes.c_int * 3)()
    status = library().groma_decode_megakernel(
        x.data_ptr(), out.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        mask_bias.data_ptr(), cur_bias.data_ptr(), sp['ln1'].data_ptr(),
        sp['ln2'].data_ptr(), sp['table'].data_ptr(), sp['maps'].data_ptr(),
        kv['table'].data_ptr(), sp['plan'].data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), act.data_ptr(), work.data_ptr(), sync.data_ptr(),
        None if stamps is None else stamps.data_ptr(), pos.data_ptr(),
        n_layers, b, h, s, f, sp['ctas'], eps, info, stream_ptr(x))
    check(status, 'decode_megakernel')
    fused_decode_step.launches += 1
    fused_decode_step.blocks = info[0]
    fused_decode_step.barriers = info[1]
    fused_decode_step.smem = info[2]
    return out


def _check_cuda(sp, x, kv, mask_bias, cur_bias, cos, sin, pos):
    """Raise unless the kernel takes these tensors; -> the device word of
    ``pos`` (a host int filled into one)."""
    if x.device.type != 'cuda':
        raise ValueError(f'fused_decode_step: unsupported device {x.device}')
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    if pos.dtype != torch.int32 or pos.numel() != 1 \
            or pos.device != x.device:
        raise ValueError('fused_decode_step: pos is a host int or one int32 '
                         'word on the device of x')
    b, d = x.shape
    f = sp['wdn'][0].shape[0] * 2
    s = kv['k'][0].shape[2]
    if (not 1 <= b <= MAX_BATCH or d % HEAD_DIM
            or d % INT4_BLOCK or f % INT4_BLOCK
            or kv['k'][0].shape != (b, d // HEAD_DIM, s, HEAD_DIM)
            or mask_bias.shape != (b, s) or cur_bias.numel() != b
            or cos.shape != (b, HEAD_DIM) or sin.shape != (b, HEAD_DIM)):
        raise ValueError(f'fused_decode_step: x {tuple(x.shape)}, F {f}, '
                         f'cache {tuple(kv["k"][0].shape)}, mask '
                         f'{tuple(mask_bias.shape)}; the kernel takes '
                         f'B <= {MAX_BATCH}, 128-wide heads, D and F '
                         f'multiples of {INT4_BLOCK}')
    tensors = (x, mask_bias, cur_bias, cos, sin)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != x.device for t in tensors):
        raise ValueError('fused_decode_step: x, the biases and cos/sin must '
                         'be contiguous f32 on the same device')
    if sp.get('table') is None or kv.get('table') is None \
            or sp['table'].device != x.device \
            or kv['table'].device != x.device:
        raise ValueError('fused_decode_step: stack the params and the cache '
                         'on the device of x')
    # the kernel reads x by 16 bytes and the weights, the cache and the
    # mask by bulk copies of 16-byte granules from each tensor's base
    if any(a % 16 for a in (x.data_ptr(), mask_bias.data_ptr(),
                            *sp['ptrs'], *kv['ptrs'])):
        raise ValueError('fused_decode_step: x, mask_bias, the weights and '
                         'the cache buffers must start at 16-byte aligned '
                         'addresses')
    return pos


def fused_decode_step(sp: dict, x, kv: dict, mask_bias, cur_bias, cos, sin,
                      pos, eps: float = 1e-5):
    """One decode step over all L layers.

    sp: ``stack_decode_params``; x (B, D) f32, the hidden state after the
    embedding; kv: ``stack_kv_cache``, updated in place at ``pos``;
    mask_bias (B, S) f32 (0 / -1e30) over the OLD positions, -1e30 at
    ``pos`` and beyond; cur_bias (B, 1) f32, this token's validity bias;
    cos/sin (B, 128) f32 RoPE rows at this token's position; pos, the
    scalar cache slot, 0 <= pos < S: a host int (checked) or a 0-d int32
    tensor on the device of x, which the kernel reads when it runs.
    Returns the (B, D) f32 hidden state before the final norm.

    CPU tensors: the plain version.  CUDA tensors: the kernel, for B <= 8,
    128-wide MHA heads, D and F multiples of 256; x, the biases and the
    tables f32 and contiguous.  A launch sets ``fused_decode_step.blocks``
    to its grid (one CTA per SM, as the params' plan was made); a grid
    that cannot be co-resident, or shared memory that cannot be had, is
    refused with an error."""
    s = kv['k'][0].shape[2]
    if not torch.is_tensor(pos) and not 0 <= pos < s:
        raise ValueError(f'decode position {pos} outside the {s}-slot '
                         f'cache')
    if (sp.get('ptrs') != _addresses(sp, _PARAM_KEYS)
            or kv.get('ptrs') != _addresses(kv, _CACHE_KEYS)):
        raise ValueError('fused_decode_step: a weight or cache buffer was '
                         'replaced after stacking; stack again')
    if x.device.type == 'cpu':
        return fused_decode_step_plain(sp, x, kv, mask_bias, cur_bias, cos,
                                       sin, pos, eps)
    pos = _check_cuda(sp, x, kv, mask_bias, cur_bias, cos, sin, pos)
    return _launch(sp, x, kv, mask_bias, cur_bias, cos, sin, pos, eps)


fused_decode_step.launches = 0
fused_decode_step.blocks = 0
fused_decode_step.barriers = 0
fused_decode_step.smem = 0


def phase_stamps(sp, x, kv, mask_bias, cur_bias, cos, sin, pos,
                 eps: float = 1e-5):
    """One launch of the kernel on CUDA tensors, as ``fused_decode_step``,
    that also records each block's ``%globaltimer`` (ns): at its start, at
    its end, and for each layer and phase (``PHASES``) when its last thread
    is done with the phase and when it leaves the wait that follows.
    Returns (out, stamps (blocks, 2 + 10 L) int64)."""
    pos = _check_cuda(sp, x, kv, mask_bias, cur_bias, cos, sin, pos)
    stamps = torch.zeros((sp['ctas'], 2 + 2 * len(PHASES) * len(sp['wqkv'])),
                         dtype=torch.int64, device=x.device)
    out = _launch(sp, x, kv, mask_bias, cur_bias, cos, sin, pos, eps,
                  stamps)
    return out, stamps


def phase_split(stamps, n_layers: int) -> dict:
    """How a stamped launch's time splits, in ms summed over the layers:
    for each phase of ``PHASES`` the blocks' mean work (from leaving the
    previous wait to finishing the phase), the idle tail (the mean wait
    of a block for the latest one to finish the phase) and the barrier
    (from that latest finish to the mean release); and 'total', the mean
    block's time from start to end, which the parts add up to."""
    t = stamps.to(torch.float64)
    arrive = t[:, 2::2].reshape(-1, n_layers, len(PHASES))
    release = t[:, 3::2].reshape(-1, n_layers, len(PHASES))
    prev = torch.cat([t[:, :1], release.reshape(len(t), -1)[:, :-1]],
                     1).reshape(arrive.shape)
    latest = arrive.amax(0)
    out = {'total': (t[:, 1] - t[:, 0]).mean().item() / 1e6,
           'end': (t[:, 1] - release[:, -1, -1]).mean().item() / 1e6}
    for i, name in enumerate(PHASES):
        out[name] = ((arrive - prev)[..., i].mean(0).sum().item() / 1e6)
        out[name + ' tail'] = ((latest - arrive)[..., i].mean(0).sum()
                               .item() / 1e6)
        out[name + ' barrier'] = ((release.mean(0) - latest)[..., i].sum()
                                  .item() / 1e6)
    return out
