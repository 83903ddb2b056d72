"""Weight-only int8 LLaMA inference with an int8 KV cache (counterpart of
``groma_tpu/models/llama_quant.py``).

Weights are pre-quantized into a plain dict (qkv and gate/up fused along
the output dim, per-column int8 scales exact under the concatenation); the
matmuls go through ``ops.quant.int8_matmul`` and single-token attention over
the int8 cache through ``ops.decode_attention.int8_decode_attention``.

Ported: the scalar-index prefill and decode branches of
``quant_llama_forward``.  The vector-index (continuous batching) and
chunked-append branches belong to the serving engine and are not ported
yet.  Unlike JAX, whose ``dynamic_update_slice`` clamps a write past the
cache end, a write that does not fit raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from groma_tpu.config import LlamaConfig
from groma_tpu_torch.models.llama import (apply_rope, rms_norm, rope_tables,
                                          torch_dtype)
from groma_tpu_torch.ops.decode_attention import int8_decode_attention
from groma_tpu_torch.ops.quant import int8_matmul, quantize_weight, true_div

NEG_INF = -1e30


def quantize_llama_layer(w: dict) -> dict:
    """One decoder layer's HF-named weights (``self_attn.q_proj.weight``,
    ``mlp.gate_proj.weight``, ``input_layernorm.weight`` ...) -> the fused
    int8 layer dict.  Kernels are (K, N) = weight.T."""
    def q(kernel):
        qw, s = quantize_weight(kernel)
        return {'q': qw, 'scale': s}

    qkv = torch.cat([w['self_attn.q_proj.weight'].T,
                     w['self_attn.k_proj.weight'].T,
                     w['self_attn.v_proj.weight'].T], dim=1)
    gate_up = torch.cat([w['mlp.gate_proj.weight'].T,
                         w['mlp.up_proj.weight'].T], dim=1)
    return {
        'input_layernorm': w['input_layernorm.weight'],
        'post_attention_layernorm': w['post_attention_layernorm.weight'],
        'qkv_proj': q(qkv),
        'o_proj': q(w['self_attn.o_proj.weight'].T),
        'gate_up_proj': q(gate_up),
        'down_proj': q(w['mlp.down_proj.weight'].T),
    }


def quantize_head(weight: torch.Tensor) -> dict:
    """(V, D) head -> int8 (D, V') padded to a multiple of 512 columns; the
    consumer slices logits back to V (quant_llama_logits)."""
    qw, s = quantize_weight(weight.T, pad_to=512)
    return {'q': qw, 'scale': s}


def quantize_llama_params(sd, cfg: LlamaConfig, bits: int = 8) -> dict:
    """HF-layout LLaMA state dict (``model.layers.N. ...``, ``model.norm``,
    ``model.embed_tokens``, ``lm_head``; or the module holding them) ->
    the int8 tree of the JAX package's ``quantize_llama_params``."""
    if bits != 8:
        raise ValueError('only bits=8 is ported (int4 and the bf16 tree '
                         'come with later parts of the port)')
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    out = {'layers': [], 'norm': sd['model.norm.weight']}
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}.'
        out['layers'].append(quantize_llama_layer(
            {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}))
    if 'model.embed_tokens.weight' in sd:
        out['embed_tokens'] = sd['model.embed_tokens.weight'].to(
            torch.bfloat16)
    if 'lm_head.weight' in sd:
        out['lm_head'] = quantize_head(sd['lm_head.weight'])
    return out


def _qmm(x, qw):
    """(..., K) @ int8 (K, N) through the int8 matmul."""
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]), qw['q'], qw['scale'])
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


def quant_llama_forward(qp: dict, cfg: LlamaConfig, inputs_embeds,
                        attn_mask, position_ids,
                        cache: Optional[dict] = None):
    """The quantized LLaMA trunk: (B, S, D) embeddings -> final-normed
    hidden states, and the cache.

    A multi-token call with a cache is PREFILL into a fresh cache (index
    0): attention runs over this call's own keys.  A single-token call with
    a cache is DECODE at the cache's scalar index: with an int8 cache the
    attention is the int8 decode kernel over the whole buffer and its mask.
    The cache is updated in place and returned.  Multi-head attention only
    (Vicuna-7B): grouped-query configs raise."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.hidden_size // cfg.num_heads
    nh = cfg.num_heads
    if cfg.num_kv_heads != nh:
        raise ValueError('num_kv_heads != num_heads (GQA) is not ported')
    cos, sin = rope_tables(position_ids, hd, cfg.rope_theta)
    x = inputs_embeds.to(dtype)
    b, s, _ = x.shape
    dev = x.device
    prefill = s > 1

    idx = 0
    kv_mask = attn_mask
    quant_kv = False
    if cache is not None:
        idx = cache['index']
        if not isinstance(idx, int):
            raise ValueError('per-row cache indices belong to the serving '
                             'engine, which is not ported yet')
        if prefill and idx != 0:
            raise ValueError('a multi-token call fills a fresh cache '
                             '(chunked appends are not ported yet)')
        max_len = cache['mask'].shape[1]
        if idx + s > max_len:
            raise ValueError(f'KV cache overflow: {s} tokens at slot {idx} '
                             f'of a {max_len}-slot cache')
        cache['mask'][:, idx:idx + s] = attn_mask[:, :s]
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
    causal_ok = kj <= qi + (0 if prefill or cache is None else idx)
    mask_bias = torch.where(causal_ok[None, None] & amask[:, None, None, :],
                            0.0, NEG_INF).to(torch.float32)

    for i, lp in enumerate(qp['layers']):
        h = rms_norm(x, lp['input_layernorm'], cfg.rms_norm_eps)
        qkv = _qmm(h, lp['qkv_proj'])
        q, k, v = (t.reshape(b, s, nh, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        q = apply_rope(q.to(dtype), cos, sin)
        k = apply_rope(k.to(dtype), cos, sin)
        v = v.to(dtype)

        if quant_kv:
            kq8, ksc = _quantize_tokens(k)
            vq8, vsc = _quantize_tokens(v)
            cache['k'][i][:, :, idx:idx + s] = kq8
            cache['v'][i][:, :, idx:idx + s] = vq8
            cache['k_scale'][i][:, :, idx:idx + s] = ksc
            cache['v_scale'][i][:, :, idx:idx + s] = vsc
        elif cache is not None:
            cache['k'][i][:, :, idx:idx + s] = k
            cache['v'][i][:, :, idx:idx + s] = v
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
        attn = attn.to(dtype).transpose(1, 2).reshape(b, s, -1)
        x = x + _qmm(attn, lp['o_proj']).to(dtype)

        h = rms_norm(x, lp['post_attention_layernorm'], cfg.rms_norm_eps)
        gate, up = _qmm(h, lp['gate_up_proj']).chunk(2, dim=-1)
        x = x + _qmm((F.silu(gate) * up).to(dtype),
                     lp['down_proj']).to(dtype)

    x = rms_norm(x, qp['norm'], cfg.rms_norm_eps)
    if cache is not None:
        cache['index'] = idx + s
    return x, cache


def quant_llama_logits(qp: dict, hidden):
    """Base-vocabulary logits through the int8 head, its pad columns
    dropped."""
    logits = _qmm(hidden, qp['lm_head'])
    return logits[..., :qp['embed_tokens'].shape[0]]
