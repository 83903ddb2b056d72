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
continuous-batching engine, per-row positions), ``quant_llama_decode_paged``
and ``quant_llama_decode_megakernel`` (the whole int4 + int8-KV decode step
in one launch of ``ops.decode_megakernel``).  The vector-index multi-token
append and ``chunked=True`` (speculative verify, chunked prefill) are not
ported and raise.  The scalar index is a host int or a 0-d int64 tensor
on the cache's device (decode only): a CUDA graph can capture a decode at
a tensor index, which advances in place, as a per-row index does.  Unlike
JAX, whose ``dynamic_update_slice`` clamps a write past the cache end, a
host-index write that does not fit raises; an index tensor must stay
inside the cache (the caller checks once per run, and the engine does not
advance idle rows).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from groma_tpu_torch.config import LlamaConfig
from groma_tpu_torch.models.llama import (apply_rope, rms_norm, rope_tables,
                                          torch_dtype)
from groma_tpu_torch.ops.decode_attention import int8_decode_attention
from groma_tpu_torch.ops.paged_attention import (PAGE,
                                                 paged_int8_decode_attention)
from groma_tpu_torch.ops.quant import int8_matmul, quantize_weight, true_div
from groma_tpu_torch.ops.quant4 import (INT4_BLOCK, int4_matmul,
                                        quantize_weight_int4)

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


def _qmm(x, qw):
    """(..., K) @ quantized (K, N): uint8 storage is packed int4, int8
    per-column int8, bf16 the unquantized tree (a bf16 product with f32
    sums, in x's dtype)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    q = qw['q']
    if q.dtype == torch.bfloat16:
        # JAX's bf16 dot with f32 sums, cast to x's dtype
        y = x2 @ q if x2.dtype == torch.bfloat16 else \
            (x2.to(torch.bfloat16).float() @ q.float()).to(x2.dtype)
    elif q.dtype == torch.uint8:
        y = int4_matmul(x2, q, qw['scale'])
    else:
        y = int8_matmul(x2, q, qw['scale'])
    return y.reshape(*lead, -1)


# --------------------------------------------------------- int8 KV cache

def make_quant_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                        device=None) -> dict:
    """int8 KV cache with per-(batch, head, position) f32 scales, one
    buffer per layer, written in place by quant_llama_forward."""
    hd = cfg.hidden_size // cfg.num_heads
    shape = (batch, cfg.num_kv_heads, max_len, hd)
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


def _project_qkv(x, lp, cfg: LlamaConfig, cos, sin):
    """A layer's input norm and fused qkv -> roped q, k and v
    (B, H, S, hd) in the model dtype."""
    dtype = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    h = rms_norm(x, lp['input_layernorm'], cfg.rms_norm_eps)
    q, k, v = (t.reshape(b, s, nh, hd).transpose(1, 2)
               for t in _qmm(h, lp['qkv_proj']).chunk(3, dim=-1))
    return (apply_rope(q.to(dtype), cos, sin),
            apply_rope(k.to(dtype), cos, sin), v.to(dtype))


def _finish_layer(x, attn, lp, cfg: LlamaConfig):
    """Attention output projection and the MLP, both residual."""
    dtype = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    attn = attn.to(dtype).transpose(1, 2).reshape(b, s, -1)
    x = x + _qmm(attn, lp['o_proj']).to(dtype)
    h = rms_norm(x, lp['post_attention_layernorm'], cfg.rms_norm_eps)
    gate, up = _qmm(h, lp['gate_up_proj']).chunk(2, dim=-1)
    return x + _qmm((F.silu(gate) * up).to(dtype), lp['down_proj']).to(dtype)


def _write(buf, at, t):
    """Write this call's (B, H, S[, D]) rows ``t`` into a cache buffer at
    ``at``: a host slice, a (1,) device slot (index_copy_) or the per-row
    (rows, slice, index) tuple."""
    if torch.is_tensor(at):
        buf.index_copy_(2, at, t)
    elif isinstance(at, tuple):
        buf[at] = t[:, :, 0]
    else:
        buf[:, :, at] = t


def quant_llama_forward(qp: dict, cfg: LlamaConfig, inputs_embeds,
                        attn_mask, position_ids,
                        cache: Optional[dict] = None):
    """The quantized LLaMA trunk: (B, S, D) embeddings -> final-normed
    hidden states, and the cache.

    A multi-token call with a cache is PREFILL into a fresh cache (index
    0): attention runs over this call's own keys.  A single-token call with
    a cache is DECODE: at the cache's scalar index, or, when
    ``cache['index']`` is a (B,) tensor, at each row's own index (the
    continuous-batching engine), every row seeing the slots up to its
    index.  With an int8 cache the attention is the int8 decode kernel over
    the whole buffer and its mask.  The cache is updated in place and
    returned; every row's index advances by S, as in JAX (a tensor index
    in place).  Multi-head
    attention only (Vicuna-7B): grouped-query configs raise."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.hidden_size // cfg.num_heads
    if cfg.num_kv_heads != cfg.num_heads:
        raise ValueError('num_kv_heads != num_heads (GQA) is not ported')
    cos, sin = rope_tables(position_ids, hd, cfg.rope_theta)
    x = inputs_embeds.to(dtype)
    b, s, _ = x.shape
    dev = x.device
    prefill = s > 1

    idx = 0
    kv_mask = attn_mask
    quant_kv = False
    device_index = cache is not None and torch.is_tensor(cache['index'])
    vector = device_index and cache['index'].dim() == 1
    rows = torch.arange(b, device=dev)
    if device_index:
        idx = cache['index']
        if s != 1:
            raise ValueError('cache index tensors take one token a row '
                             '(multi-token appends are not ported)')
        if vector:
            cache['mask'][rows, idx] = attn_mask[:, 0]
        else:
            cache['mask'].index_copy_(1, idx.view(1), attn_mask[:, :1])
    elif cache is not None:
        idx = cache['index']
        if prefill and idx != 0:
            raise ValueError('a multi-token call fills a fresh cache '
                             '(chunked appends are not ported)')
        max_len = cache['mask'].shape[1]
        if idx + s > max_len:
            raise ValueError(f'KV cache overflow: {s} tokens at slot {idx} '
                             f'of a {max_len}-slot cache')
        cache['mask'][:, idx:idx + s] = attn_mask[:, :s]
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
        causal_ok = (kj <= idx[:, None])[:, None, None, :]   # (B, 1, 1, S)
    else:
        causal_ok = (kj <= qi + (0 if prefill or cache is None
                                 else idx))[None, None]
    mask_bias = torch.where(causal_ok & amask[:, None, None, :],
                            0.0, NEG_INF).to(torch.float32)

    at = (rows, slice(None), idx) if vector else idx.view(1) if device_index \
        else slice(idx, idx + s)
    for i, lp in enumerate(qp['layers']):
        q, k, v = _project_qkv(x, lp, cfg, cos, sin)
        if cache is not None:
            if quant_kv:
                kq8, ksc = _quantize_tokens(k)
                vq8, vsc = _quantize_tokens(v)
                _write(cache['k'][i], at, kq8)
                _write(cache['v'][i], at, vq8)
                _write(cache['k_scale'][i], at, ksc)
                _write(cache['v_scale'][i], at, vsc)
            else:
                _write(cache['k'][i], at, k.to(cache['k'][i].dtype))
                _write(cache['v'][i], at, v.to(cache['v'][i].dtype))
                if not prefill:
                    k, v = cache['k'][i], cache['v'][i]

        if quant_kv and not prefill:
            attn = int8_decode_attention(
                q, cache['k'][i], cache['k_scale'][i], cache['v'][i],
                cache['v_scale'][i], mask_bias)
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
        x = _finish_layer(x, attn, lp, cfg)

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
    design.  MHA only.  The pools are updated in place; returns
    (hidden (B, 1, D), pools)."""
    hd = cfg.hidden_size // cfg.num_heads
    if cfg.num_kv_heads != cfg.num_heads:
        raise ValueError('paged decode requires MHA')
    b, s, _ = inputs_embeds.shape
    if s != 1:
        raise ValueError('paged decode takes one token a row')
    cos, sin = rope_tables(position_ids, hd, cfg.rope_theta)
    x = inputs_embeds.to(torch_dtype(cfg.dtype))
    pos = position_ids[:, 0].long()
    rows = torch.arange(b, device=x.device)
    at = (table[rows, pos // PAGE].long(), slice(None), pos % PAGE)

    for i, lp in enumerate(qp['layers']):
        q, k, v = _project_qkv(x, lp, cfg, cos, sin)
        kq8, ksc = _quantize_tokens(k)
        vq8, vsc = _quantize_tokens(v)
        pools['k'][i][at] = kq8[:, :, 0]
        pools['v'][i][at] = vq8[:, :, 0]
        pools['k_scale'][i][at] = ksc[:, :, 0]
        pools['v_scale'][i][at] = vsc[:, :, 0]
        attn = paged_int8_decode_attention(
            q, pools['k'][i], pools['k_scale'][i], pools['v'][i],
            pools['v_scale'][i], table, lengths)
        x = _finish_layer(x, attn, lp, cfg)

    return rms_norm(x, qp['norm'], cfg.rms_norm_eps), pools


def quant_llama_logits(qp: dict, hidden):
    """Base-vocabulary logits through the tree's head (int8, int4 or the
    bits=16 bf16 one), its pad columns dropped."""
    logits = _qmm(hidden, qp['lm_head'])
    return logits[..., :qp['embed_tokens'].shape[0]]
