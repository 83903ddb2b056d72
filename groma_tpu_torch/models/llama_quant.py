"""Weight-only int8 / int4 LLaMA inference with an int8 KV cache
(counterpart of ``groma_tpu/models/llama_quant.py``).

Weights are pre-quantized into a plain dict (qkv and gate/up fused along
the output dim; per-column int8 scales, and int4's per-(256-row block,
column) scales, stay exact under the concatenation).  ``_qmm`` dispatches
on the stored dtype: uint8 is packed int4 (``ops.quant4.int4_matmul``),
int8 per-column int8 (``ops.quant.int8_matmul``), bf16 the unquantized
``bits=16`` tree.  Single-token attention over the int8 cache goes through
``ops.decode_attention.int8_decode_attention``, over the engine's page pool
through ``ops.paged_attention.paged_int8_decode_attention``.

Ported: the scalar-index prefill and decode branches of
``quant_llama_forward``, its vector-index single-token decode (the
continuous-batching engine, per-row positions), the chunked append at a
scalar index (``chunked=True``: a multi-token chunk written at the cache
index, attending over the whole buffer through its mask; speculative
verify; the engine's chunked prefill), the vector-index multi-token
append (``chunked=True`` with a (B,) index: row b writes its S tokens at
slots ``index[b] .. index[b] + S - 1``; the engine's speculative verify),
W8A8 prefill (``w8a8=True``: the four layer matmuls of a
multi-token call through ``ops.quant.w8a8_matmul`` from 256 rows on,
int8 weights only), the flash prefill (``use_flash=True``: #4 from
``FLASH_MIN_SEQ`` tokens on), ``quant_llama_decode_paged`` and
``quant_llama_decode_megakernel`` (the whole int4 + int8-KV decode step
in one launch of ``ops.decode_megakernel``), and grouped-query attention
(``num_kv_heads < num_heads``) by JAX's route: the fused qkv narrows to
``(num_heads + 2 * num_kv_heads) * head_dim`` columns, a decode over an
int8 cache dequantizes the layer's cache, the K/V heads are repeated, and
the int8 decode kernel runs only without GQA (the paged decode, the
engine's paged mode and the megakernel refuse GQA, as JAX's do).  The
scalar index is a host
int or a 0-d int64 tensor on the cache's device: a CUDA graph can capture
a decode or a chunked append at a tensor index, which advances in place,
as a per-row index does.  Unlike JAX, whose ``dynamic_update_slice``
clamps a write past the cache end and whose scatter drops one, a
host-index write that does not fit raises; an index tensor must keep
every write inside the cache (a CUDA scatter out of range is a device
assert: the caller checks, and the engine does not advance idle rows).

A tree cut for tensor parallelism (``parallel/mesh.cut_quant_tree``,
its record under ``qp['tp']``) runs every mode but the W8A8 prefill and
the megakernel on this rank's heads and columns: ``_project_qkv`` splits
its local q | k | v heads (``local_heads``), ``o_proj`` and
``down_proj`` are row-parallel (``_row_qmm``: the partial sums written
in f32, all-reduced, cast once), the caches and pools hold the local KV
heads, and the head's vocabulary columns are gathered.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from groma_tpu_torch.config import LlamaConfig
from groma_tpu_torch.models.layers import cast_linear
from groma_tpu_torch.models.llama import (FLASH_MIN_SEQ, apply_rope,
                                          rms_norm, rope_tables, torch_dtype)
from groma_tpu_torch.ops.decode_attention import int8_decode_attention
from groma_tpu_torch.ops.flash_attention import flash_attention
from groma_tpu_torch.ops.paged_attention import (PAGE,
                                                 paged_int8_decode_attention)
from groma_tpu_torch.ops.quant import (DENSE_MIN_ROWS, int8_matmul,
                                       quantize_weight, true_div,
                                       w8a8_matmul, w8a8_weight)
from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, int4_matmul,
                                        quantize_weight_int4)
from groma_tpu_torch.parallel.tensor_parallel import (row_parallel_quant,
                                                      vocab_parallel_logits)

NEG_INF = -1e30


def quantize_kernel(kernel: torch.Tensor, bits: int = 8,
                    pad_to: int = 0) -> dict:
    """One (K, N) kernel -> its leaf, by the JAX package's rule: ``bits=16``
    keeps bf16 ({'q'}); ``bits=4`` packs int4 where K is a multiple of
    INT4_BLOCK and falls back to int8 elsewhere ({'q', 'scale'}).
    ``pad_to`` zero-pads N to a multiple."""
    if bits not in (16, 8, 4):
        raise ValueError(f'bits must be 16, 8 or 4, not {bits}')
    if bits == 16:
        if pad_to and kernel.shape[1] % pad_to:
            kernel = F.pad(kernel, (0, (-kernel.shape[1]) % pad_to))
        return {'q': kernel.to(torch.bfloat16).contiguous()}
    if bits == 4 and kernel.shape[0] % INT4_BLOCK == 0:
        qd = quantize_weight_int4(kernel, block=INT4_BLOCK, pad_to=pad_to)
        return {'q': qd['q'], 'scale': qd['scale']}
    qw, s = quantize_weight(kernel, pad_to=pad_to)
    return {'q': qw, 'scale': s}


def quantize_llama_layer(w: dict, bits: int = 8) -> dict:
    """One decoder layer's HF-named weights (``self_attn.q_proj.weight``,
    ``mlp.gate_proj.weight``, ``input_layernorm.weight`` ...) -> the fused
    layer dict.  Kernels are (K, N) = weight.T."""
    qkv = torch.cat([w['self_attn.q_proj.weight'].T,
                     w['self_attn.k_proj.weight'].T,
                     w['self_attn.v_proj.weight'].T], dim=1)
    gate_up = torch.cat([w['mlp.gate_proj.weight'].T,
                         w['mlp.up_proj.weight'].T], dim=1)
    return {
        'input_layernorm': w['input_layernorm.weight'],
        'post_attention_layernorm': w['post_attention_layernorm.weight'],
        'qkv_proj': quantize_kernel(qkv, bits),
        'o_proj': quantize_kernel(w['self_attn.o_proj.weight'].T, bits),
        'gate_up_proj': quantize_kernel(gate_up, bits),
        'down_proj': quantize_kernel(w['mlp.down_proj.weight'].T, bits),
    }


def quantize_head(weight: torch.Tensor, bits: int = 8) -> dict:
    """(V, D) head -> (D, V') padded to a multiple of 512 columns; the
    consumer slices logits back to V (quant_llama_logits)."""
    return quantize_kernel(weight.T, bits, pad_to=512)


def quantize_llama_params(sd, cfg: LlamaConfig, bits: int = 8) -> dict:
    """HF-layout LLaMA state dict (``model.layers.N. ...``, ``model.norm``,
    ``model.embed_tokens``, ``lm_head``; or the module holding them) ->
    the tree of the JAX package's ``quantize_llama_params`` (bits 8, 4 or
    16)."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    out = {'layers': [], 'norm': sd['model.norm.weight']}
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}.'
        out['layers'].append(quantize_llama_layer(
            {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}, bits))
    if 'model.embed_tokens.weight' in sd:
        out['embed_tokens'] = sd['model.embed_tokens.weight'].to(
            torch.bfloat16)
    if 'lm_head.weight' in sd:
        out['lm_head'] = quantize_head(sd['lm_head.weight'], bits)
    return out


W8A8_MATMULS = ('qkv_proj', 'o_proj', 'gate_up_proj', 'down_proj')
W8A8_UNDER_TP = ('the W8A8 prefill does not run on a tp-cut tree (its '
                 'activation scales are maxima over the whole K): '
                 'ROADMAP.md §1 item 11f')


def w8a8_weights(qp: dict) -> Optional[list]:
    """The W8A8 prefill's copies of a tree's int8 layer weights, K-major
    (``ops.quant.w8a8_weight``): per layer a dict of the four matmuls'
    (K, N) views, or None for a tree with no int8 layer weight (int4 or
    bf16, which ``w8a8`` leaves weight-only).  The weights' size again in
    memory (6.5 GB at 7B): made once by the owner of a W8A8 prefill
    (``QuantGenerator``, ``BatchEngine``) and passed as ``kmajor``; the
    tree itself is not touched."""
    out = [{name: w8a8_weight(lp[name]['q']) for name in W8A8_MATMULS
            if lp[name]['q'].dtype == torch.int8} for lp in qp['layers']]
    return out if any(out) else None


def _qmm(x, qw, a8: bool = False, kmajor=None, out_dtype=None):
    """(..., K) @ quantized (K, N): uint8 storage is packed int4, int8
    per-column int8, bf16 the unquantized tree (a bf16 product with f32
    sums, in x's dtype).  ``a8``: int8 weights with at least 256 rows take
    the W8A8 product (``w8a8_matmul``), on ``kmajor`` (the same weights
    K-major, ``w8a8_weights``) where given, else on the stored ones; int4
    and bf16 trees ignore it.  ``out_dtype=torch.float32``: the
    weight-only products' sums in f32, unrounded (a row-parallel partial
    sum; W8A8 is refused under tensor parallelism)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    q = qw['q']
    if q.dtype == torch.bfloat16:
        # JAX's bf16 dot with f32 sums, cast to x's dtype
        if out_dtype == torch.float32:
            y = cast_linear(x2.to(torch.bfloat16), q.t(), torch.float32)
        elif x2.dtype == torch.bfloat16:
            y = x2 @ q
        else:
            y = (x2.to(torch.bfloat16).float() @ q.float()).to(x2.dtype)
    elif q.dtype == torch.uint8:
        y = int4_matmul(x2, q, qw['scale'], out_dtype=out_dtype)
    elif a8 and x2.shape[0] >= DENSE_MIN_ROWS:
        y = w8a8_matmul(x2, q if kmajor is None else kmajor, qw['scale'])
    else:
        y = int8_matmul(x2, q, qw['scale'], out_dtype=out_dtype)
    return y.reshape(*lead, -1)


def _row_qmm(x, qw, tp, a8: bool = False, kmajor=None):
    """A row-parallel leaf's product (``o_proj``, ``down_proj``): ``_qmm``
    without a tp cut; on a cut tree (``tp``, the tree's ``'tp'`` record)
    this rank's rows' partial sum in f32, all-reduced over the group and
    cast once to x's dtype."""
    if tp is None:
        return _qmm(x, qw, a8, kmajor)
    return row_parallel_quant(x, qw, tp['group'], _qmm)


def local_heads(qp: dict, cfg: LlamaConfig) -> tuple:
    """(query heads, KV heads) a tree computes on: its tp rank's
    (``mesh.cut_quant_tree``) or the config's."""
    tp = qp.get('tp')
    if tp is None:
        return cfg.num_heads, cfg.num_kv_heads
    return tp['heads'], tp['kv_heads']


def _kv_of_queries(qp: dict, cfg: LlamaConfig, device):
    """The KV head of each local query head where a cut tree keeps the KV
    heads whole beside a slice of the query heads (GQA with fewer KV
    heads than tp: an index into the whole KV heads), else None (the
    local heads repeat as the whole ones do)."""
    tp = qp.get('tp')
    if tp is None or tp['kv_heads'] * tp['size'] == cfg.num_kv_heads:
        return None
    rep = cfg.num_heads // cfg.num_kv_heads
    first = tp['q_first']
    return torch.arange(first, first + tp['heads'], device=device) // rep


# --------------------------------------------------------- int8 KV cache

def make_quant_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                        device=None, kv_heads: Optional[int] = None) -> dict:
    """int8 KV cache with per-(batch, head, position) f32 scales, one
    buffer per layer, written in place by quant_llama_forward.
    ``kv_heads``: the KV heads a cut tree's rank holds (``local_heads``;
    default ``cfg.num_kv_heads``)."""
    hd = cfg.hidden_size // cfg.num_heads
    shape = (batch, kv_heads or cfg.num_kv_heads, max_len, hd)
    nl = cfg.num_layers
    return {
        'k': [torch.zeros(shape, dtype=torch.int8, device=device)
              for _ in range(nl)],
        'v': [torch.zeros(shape, dtype=torch.int8, device=device)
              for _ in range(nl)],
        'k_scale': [torch.zeros(shape[:-1], device=device)
                    for _ in range(nl)],
        'v_scale': [torch.zeros(shape[:-1], device=device)
                    for _ in range(nl)],
        'mask': torch.zeros((batch, max_len), dtype=torch.bool,
                            device=device),
        'index': 0,
    }


def _quantize_tokens(x):
    """(B, H, S, D) float -> (int8, (B, H, S) f32 scale), symmetric
    per-token-per-head absmax."""
    xf = x.to(torch.float32)
    a = xf.abs().amax(-1)
    sc = torch.where(a > 0, true_div(a, 127.0), torch.ones_like(a))
    q = torch.round(xf / sc[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), sc


def _int8_cache_attention(q, k_q, k_s, v_q, v_s, mask_bias):
    """The XLA chain the TPU decode kernel replaced (its oracle): softmax
    first, then the v scale folded into p and p requantized per row.
    Integer dots in f64, where they are exact."""
    d = q.shape[-1]
    q8, qs = _quantize_tokens(q)                       # (B,H,1,D), (B,H,1)
    s = torch.einsum('bhqd,bhkd->bhqk', q8.double(), k_q.double()).float()
    s = s * qs[..., None] * k_s[:, :, None, :] * (d ** -0.5)
    p = torch.softmax(s + mask_bias, dim=-1)
    ps = p * v_s[:, :, None, :]
    r = ps.amax(-1, keepdim=True)
    r = torch.where(r > 0, true_div(r, 127.0), torch.ones_like(r))
    ps8 = torch.round(ps / r)
    out = torch.einsum('bhqk,bhkd->bhqd', ps8.double(), v_q.double())
    return out.float() * r


def _project_qkv(x, lp, cfg: LlamaConfig, cos, sin, a8: bool = False,
                 kmajor=None, heads: Optional[tuple] = None):
    """A layer's input norm and fused qkv -> roped q, k and v
    (B, H, S, hd) in the model dtype (``a8``, ``kmajor``: ``_qmm``'s, the
    layer's dict of K-major copies; ``heads``: the (query, KV) heads of
    the qkv columns, ``local_heads``, default the config's)."""
    dtype = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    nh, nkv = heads or (cfg.num_heads, cfg.num_kv_heads)
    hd = cfg.hidden_size // cfg.num_heads
    h = rms_norm(x, lp['input_layernorm'], cfg.rms_norm_eps)
    qkv = _qmm(h, lp['qkv_proj'], a8, (kmajor or {}).get('qkv_proj'))
    q, k, v = (t.reshape(b, s, n, hd).transpose(1, 2) for t, n in zip(
        qkv.split([nh * hd, nkv * hd, nkv * hd], -1), (nh, nkv, nkv)))
    return (apply_rope(q.to(dtype), cos, sin),
            apply_rope(k.to(dtype), cos, sin), v.to(dtype))


def _finish_layer(x, attn, lp, cfg: LlamaConfig, a8: bool = False,
                  kmajor=None, tp: Optional[dict] = None):
    """Attention output projection and the MLP, both residual; on a cut
    tree (``tp``, its ``'tp'`` record) ``o_proj`` and ``down_proj`` are
    row-parallel (``_row_qmm``)."""
    dtype = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    kmajor = kmajor or {}
    attn = attn.to(dtype).transpose(1, 2).reshape(b, s, -1)
    x = x + _row_qmm(attn, lp['o_proj'], tp, a8,
                     kmajor.get('o_proj')).to(dtype)
    h = rms_norm(x, lp['post_attention_layernorm'], cfg.rms_norm_eps)
    gate, up = _qmm(h, lp['gate_up_proj'], a8,
                    kmajor.get('gate_up_proj')).chunk(2, dim=-1)
    return x + _row_qmm((F.silu(gate) * up).to(dtype), lp['down_proj'], tp,
                        a8, kmajor.get('down_proj')).to(dtype)


def _write(buf, at, t):
    """Write this call's (B, H, S[, D]) rows ``t`` into a cache buffer at
    ``at``: a host slice, device slots (S,) (index_copy_), the per-row
    (rows (B,), slice, index (B,)) tuple of a decode, or the (rows (B, 1),
    slice, slots (B, S)) tuple of a multi-token append."""
    if torch.is_tensor(at):
        buf.index_copy_(2, at, t)
    elif isinstance(at, tuple) and at[2].dim() == 1:
        buf[at] = t[:, :, 0]
    elif isinstance(at, tuple):
        # advanced indices on dims 0 and 2 put (B, S) first
        buf[at] = t.transpose(1, 2)
    else:
        buf[:, :, at] = t


def _dequantize_cache(q8, scale, dtype):
    """An int8 cache layer (B, H, S, D) and its (B, H, S) scales -> the
    whole buffer in ``dtype``."""
    return (q8.to(torch.float32) * scale[..., None]).to(dtype)


def quant_llama_forward(qp: dict, cfg: LlamaConfig, inputs_embeds,
                        attn_mask, position_ids,
                        cache: Optional[dict] = None,
                        use_flash: bool = False, chunked: bool = False,
                        w8a8: bool = False,
                        kmajor: Optional[list] = None):
    """The quantized LLaMA trunk: (B, S, D) embeddings -> final-normed
    hidden states, and the cache.

    A multi-token call with a cache is PREFILL into a fresh cache (index
    0): attention runs over this call's own keys, through the flash kernel
    (#4, causal, key mask) when ``use_flash`` and S >= FLASH_MIN_SEQ.  With
    ``chunked=True`` a multi-token call APPENDS its chunk at the cache's
    scalar index instead (a host int, or a 0-d device tensor, the chunk's
    slots ``index + arange(S)``), or at each row's own index where
    ``cache['index']`` is a (B,) tensor (row b's slots ``index[b] +
    arange(S)``, its query j seeing the slots up to ``index[b] + j``), and
    attends over the whole buffer through its mask, an int8 cache
    dequantized to the model dtype per layer.  A
    single-token call with a cache is DECODE: at the cache's scalar index,
    or, when ``cache['index']`` is a (B,) tensor, at each row's own index
    (the continuous-batching engine), every row seeing the slots up to its
    index.  With an int8 cache the decode attention is the int8 decode
    kernel over the whole buffer and its mask.  ``w8a8``: a multi-token
    call's four layer matmuls take the W8A8 product (int8 weights, from
    256 rows on), on ``kmajor`` (``w8a8_weights(qp)``, which the caller
    builds once and keeps) where given; decode stays weight-only.  The
    cache is updated in place and returned; every row's index advances by
    S, as in JAX (a tensor index in place).  Grouped-query configs
    (``num_kv_heads < num_heads``) take JAX's route: a decode over an int8
    cache dequantizes the layer's cache, and every attention but the int8
    decode kernel's repeats the K/V heads; the int8 decode kernel runs
    only at ``num_kv_heads == num_heads``, as in JAX."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.hidden_size // cfg.num_heads
    rep = cfg.num_heads // cfg.num_kv_heads
    cos, sin = rope_tables(position_ids, hd, cfg.rope_theta)
    x = inputs_embeds.to(dtype)
    b, s, _ = x.shape
    dev = x.device
    tp = qp.get('tp')
    heads = local_heads(qp, cfg)
    kv_of = _kv_of_queries(qp, cfg, dev)
    if w8a8 and tp is not None and s > 1:
        raise ValueError(W8A8_UNDER_TP)
    append = chunked and s > 1 and cache is not None
    prefill = s > 1 and not append
    a8 = w8a8 and s > 1

    idx = 0
    kv_mask = attn_mask
    quant_kv = False
    device_index = cache is not None and torch.is_tensor(cache['index'])
    vector = device_index and cache['index'].dim() == 1
    rows = torch.arange(b, device=dev)
    if device_index:
        idx = cache['index']
        if s != 1 and not append:
            raise ValueError('a multi-token call at a cache index tensor '
                             'must be chunked')
        if vector and s == 1:
            cache['mask'][rows, idx] = attn_mask[:, 0]
            at = (rows, slice(None), idx)
        elif vector:
            wpos = idx[:, None] + torch.arange(s, device=dev)[None]
            cache['mask'][rows[:, None], wpos] = attn_mask[:, :s]
            at = (rows[:, None], slice(None), wpos)
        else:
            at = idx.view(1) if s == 1 else idx + torch.arange(s, device=dev)
            cache['mask'].index_copy_(1, at, attn_mask[:, :s])
    elif cache is not None:
        idx = cache['index']
        if prefill and idx != 0:
            raise ValueError('a multi-token call fills a fresh cache '
                             '(chunked=True appends)')
        max_len = cache['mask'].shape[1]
        if idx + s > max_len:
            raise ValueError(f'KV cache overflow: {s} tokens at slot {idx} '
                             f'of a {max_len}-slot cache')
        cache['mask'][:, idx:idx + s] = attn_mask[:, :s]
        at = slice(idx, idx + s)
    if cache is not None:
        kv_mask = cache['mask']
        quant_kv = cache['k'][0].dtype == torch.int8

    if prefill or cache is None:
        skv = s
        amask = attn_mask[:, :s]
    else:
        skv = kv_mask.shape[1]
        amask = kv_mask
    qi = torch.arange(s, device=dev)[:, None]
    kj = torch.arange(skv, device=dev)[None, :]
    if vector:
        # (B, 1, S, skv): row b's query j sees the slots up to index[b] + j
        causal_ok = (kj[None] <= qi[None] + idx[:, None, None])[:, None]
    else:
        causal_ok = (kj <= qi + (0 if prefill or cache is None
                                 else idx))[None, None]
    mask_bias = torch.where(causal_ok & amask[:, None, None, :],
                            0.0, NEG_INF).to(torch.float32)

    for i, lp in enumerate(qp['layers']):
        lk = kmajor[i] if kmajor is not None else None
        q, k, v = _project_qkv(x, lp, cfg, cos, sin, a8, lk, heads)
        if cache is not None:
            if quant_kv:
                kq8, ksc = _quantize_tokens(k)
                vq8, vsc = _quantize_tokens(v)
                _write(cache['k'][i], at, kq8)
                _write(cache['v'][i], at, vq8)
                _write(cache['k_scale'][i], at, ksc)
                _write(cache['v_scale'][i], at, vsc)
                if append or (not prefill and rep > 1):
                    k = _dequantize_cache(cache['k'][i],
                                          cache['k_scale'][i], dtype)
                    v = _dequantize_cache(cache['v'][i],
                                          cache['v_scale'][i], dtype)
            else:
                _write(cache['k'][i], at, k.to(cache['k'][i].dtype))
                _write(cache['v'][i], at, v.to(cache['v'][i].dtype))
                if not prefill:
                    k, v = cache['k'][i], cache['v'][i]

        if kv_of is not None:
            # this rank's query heads over the whole KV heads
            k, v = k.index_select(1, kv_of), v.index_select(1, kv_of)
        elif rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if quant_kv and not prefill and s == 1 and rep == 1:
            attn = int8_decode_attention(
                q, cache['k'][i], cache['k_scale'][i], cache['v'][i],
                cache['v_scale'][i], mask_bias)
        elif use_flash and prefill and s >= FLASH_MIN_SEQ:
            attn = flash_attention(q, k, v, kv_mask=amask, causal=True)
        else:
            # bf16 score storage with f32 softmax arithmetic at bf16
            # prefill (the JAX package's torch-autocast semantics)
            score_dtype = torch.bfloat16 if dtype == torch.bfloat16 \
                and prefill else torch.float32
            sc = torch.matmul(q.to(score_dtype),
                              k.to(score_dtype).transpose(-1, -2))
            sc = sc * torch.tensor(hd ** -0.5, dtype=score_dtype)
            sc = sc + mask_bias.to(score_dtype)
            p = torch.softmax(sc.to(torch.float32), dim=-1)
            attn = torch.matmul(p.to(v.dtype), v)
        x = _finish_layer(x, attn, lp, cfg, a8, lk, tp)

    x = rms_norm(x, qp['norm'], cfg.rms_norm_eps)
    if device_index:
        idx.add_(s)
    elif cache is not None:
        cache['index'] = idx + s
    return x, cache


def megakernel_step_inputs(cfg: LlamaConfig, cache: dict, attn_mask):
    """The per-step inputs of ``fused_decode_step`` at the cache's scalar
    index (a host int or a 0-d device tensor, read on the device): the
    (B, S) f32 bias over the OLD positions only (kj < index; the kernel
    folds the current token into the softmax itself), the (B, 1) f32 bias
    of this token from ``attn_mask[:, :1]``, and the (B, 128) f32 RoPE rows
    at the index.  Returns (mask_bias, cur_bias, cos, sin)."""
    index = cache['index']
    b, skv = cache['mask'].shape
    dev = cache['mask'].device
    kj = torch.arange(skv, device=dev)
    mask_bias = torch.where((kj < index)[None, :] & cache['mask'], 0.0,
                            NEG_INF).to(torch.float32)
    cur_bias = torch.where(attn_mask[:, :1], 0.0, NEG_INF).to(torch.float32)
    position_ids = torch.zeros((b, 1), dtype=torch.int32, device=dev) + index
    cos, sin = rope_tables(position_ids, cfg.hidden_size // cfg.num_heads,
                           cfg.rope_theta)
    return (mask_bias, cur_bias.contiguous(), cos[:, 0].contiguous(),
            sin[:, 0].contiguous())


def quant_llama_decode_megakernel(qp: dict, sp: dict, cfg: LlamaConfig,
                                  inputs_embeds, attn_mask, cache: dict):
    """Single-token decode through the all-layer megakernel
    (``ops.decode_megakernel.fused_decode_step``): one launch runs the
    whole L-layer stack, the cache updated in place.

    ``sp`` = ``stack_decode_params(qp)``; ``cache`` = ``stack_kv_cache`` of
    an int8 cache, with a scalar index: ``stack_kv_cache``'s 0-d int32
    device word, which the kernel reads and this step advances in place (a
    CUDA graph can capture the step), or a host int.  The token's position
    is the cache index (the decode benchmark's contract; the engine's
    per-row positions keep the per-layer path).  The semantics are those of
    ``quant_llama_forward``'s cached decode; a write past the cache's end
    at a host index raises, and a caller of the device word checks its run
    once.  Returns (hidden (B, 1, D), cache)."""
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    if 'tp' in qp:
        raise ValueError('the decode megakernel does not run on a tp-cut '
                         'quantized tree: ROADMAP.md §1 item 11g')
    dtype = torch_dtype(cfg.dtype)
    if inputs_embeds.shape[1] != 1:
        raise ValueError('megakernel decode takes one token a row')
    index = cache['index']
    skv = cache['mask'].shape[1]
    if not torch.is_tensor(index) and index >= skv:
        raise ValueError(f'KV cache overflow: a token at slot {index} of a '
                         f'{skv}-slot cache')
    x = fused_decode_step(
        sp, inputs_embeds[:, 0].to(torch.float32).contiguous(), cache,
        *megakernel_step_inputs(cfg, cache, attn_mask), index,
        eps=cfg.rms_norm_eps)
    x = rms_norm(x.to(dtype)[:, None, :], qp['norm'], cfg.rms_norm_eps)
    if torch.is_tensor(index):
        cache['mask'].index_copy_(1, index.long().view(1), attn_mask[:, :1])
        index.add_(1)
    else:
        cache['mask'][:, index] = attn_mask[:, 0]
        cache['index'] = index + 1
    return x, cache


def quant_llama_decode_paged(qp: dict, cfg: LlamaConfig, inputs_embeds,
                             position_ids, pools: dict, table, lengths):
    """Single-token decode against the engine's shared int8 KV page pools
    (``ops.paged_attention``).

    ``position_ids`` (B, 1): each row's write position (its kv length
    before this token); the page comes from ``table`` (B, NP) int32.
    ``lengths`` (B,) int32: the valid kv length after the write (pos + 1
    for live rows; 0 freezes a row, whose output is then the uniform
    average over its pages, finite and discarded).  Frozen rows of the
    engine all write into the trash page 0, possibly at one offset: the
    scatter takes duplicate indices, and that page's content is garbage by
    design.  MHA only, as in JAX: the paged kernel has no head repeat.  On
    a cut tree the pools hold this rank's KV heads.  The pools are updated
    in place; returns (hidden (B, 1, D), pools)."""
    hd = cfg.hidden_size // cfg.num_heads
    if cfg.num_kv_heads != cfg.num_heads:
        raise ValueError('paged decode requires MHA')
    tp, heads = qp.get('tp'), local_heads(qp, cfg)
    b, s, _ = inputs_embeds.shape
    if s != 1:
        raise ValueError('paged decode takes one token a row')
    cos, sin = rope_tables(position_ids, hd, cfg.rope_theta)
    x = inputs_embeds.to(torch_dtype(cfg.dtype))
    pos = position_ids[:, 0].long()
    rows = torch.arange(b, device=x.device)
    at = (table[rows, pos // PAGE].long(), slice(None), pos % PAGE)

    for i, lp in enumerate(qp['layers']):
        q, k, v = _project_qkv(x, lp, cfg, cos, sin, heads=heads)
        kq8, ksc = _quantize_tokens(k)
        vq8, vsc = _quantize_tokens(v)
        pools['k'][i][at] = kq8[:, :, 0]
        pools['v'][i][at] = vq8[:, :, 0]
        pools['k_scale'][i][at] = ksc[:, :, 0]
        pools['v_scale'][i][at] = vsc[:, :, 0]
        attn = paged_int8_decode_attention(
            q, pools['k'][i], pools['k_scale'][i], pools['v'][i],
            pools['v_scale'][i], table, lengths)
        x = _finish_layer(x, attn, lp, cfg, tp=tp)

    return rms_norm(x, qp['norm'], cfg.rms_norm_eps), pools


def quant_llama_logits(qp: dict, hidden):
    """Base-vocabulary logits through the tree's head (int8, int4 or the
    bits=16 bf16 one), its pad columns dropped; a head cut on its
    vocabulary gives each rank's columns, gathered."""
    logits = _qmm(hidden, qp['lm_head'])
    tp = qp.get('tp')
    if tp is not None and tp['vocab'] is not None:
        logits = vocab_parallel_logits(logits, tp['group'])
    return logits[..., :qp['embed_tokens'].shape[0]]
