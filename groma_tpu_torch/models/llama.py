"""LLaMA (counterpart of ``groma_tpu/models/llama.py``).

Ported here: ``rms_norm``, ``rope_tables``, ``apply_rope``,
``make_kv_cache``, the LLaMA weight modules under their HF state-dict names
(``model.layers.N.self_attn.q_proj.weight`` ...), which the weight bridge
loads and ``llama_quant.quantize_llama_params`` reads, and the forward of
``LlamaModel``: weights cast to ``cfg.dtype`` at use (a no-op where they are
stored in it), RMSNorm and RoPE in f32 islands, causal attention under the
stream's key mask, through the flash-attention kernels from
``FLASH_MIN_SEQ`` tokens on (``use_flash``) and the dense path below.

With a cache (``make_kv_cache``) the forward has JAX's three modes, and
writes the cache in place:
  * prefill (more than one token): k/v written at the cache's index (0),
    attention over this call's own keys;
  * decode at a scalar index: k/v written at it, attention over the whole
    buffer under its mask, query i seeing slots <= index + i.  The index
    is a host int, or a 0-d int64 tensor on the cache's device (one token
    a row), which a captured CUDA graph can hold: the forward then writes
    at the slot the tensor holds when it runs, and reads nothing back;
  * decode at a (B,) index tensor (the continuous-batching engine): each
    row's k/v written at its own index, row r seeing slots <= index[r].
A host index is rebound to index + S; an index tensor advances by S in
place.  Grouped-query configs repeat k/v over the query heads after the
cache.  Unlike JAX, whose ``dynamic_update_slice`` clamps, a write past the
cache end at a host index raises; at an index tensor the caller keeps the
decode inside the cache (a check would read the index back).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.config import LlamaConfig
from groma_tpu_torch.models.layers import cast_linear
from groma_tpu_torch.ops.flash_attention import flash_attention

# from this many query tokens on, use_flash takes the flash kernels (the
# JAX package's in-model crossover, kept as its policy)
FLASH_MIN_SEQ = 1024


def torch_dtype(name: str) -> torch.dtype:
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


def rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def rope_tables(position_ids: torch.Tensor, head_dim: int, theta: float):
    """cos/sin of shape (B, S, head_dim), HF half-rotation layout."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=position_ids.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = position_ids.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (B, S, D)."""
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    out = x32 * cos[:, None] + rot * sin[:, None]
    return out.to(x.dtype)


def make_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device=None) -> dict:
    """Per-layer (B, H, max_len, D) key/value buffers in the model dtype,
    a (B, max_len) validity mask and the write index.  The forward writes
    into them in place."""
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.hidden_size // cfg.num_heads
    shape = (batch, cfg.num_kv_heads, max_len, hd)
    return {
        'k': [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
        'v': [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
        'mask': torch.zeros((batch, max_len), dtype=torch.bool,
                            device=device),
        'index': 0,
    }


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _linear(i, o, device, dtype=None):
    return nn.Linear(i, o, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, device=None, dtype=None):
        super().__init__()
        hd = c.hidden_size // c.num_heads
        self.cfg = c
        self.q_proj = _linear(c.hidden_size, c.num_heads * hd, device, dtype)
        self.k_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device,
                              dtype)
        self.v_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device,
                              dtype)
        self.o_proj = _linear(c.num_heads * hd, c.hidden_size, device, dtype)

    def forward(self, x, cos, sin, kv_mask, use_flash: bool = False,
                cache_kv=None, cache_index=None):
        """Causal self-attention.  Without ``cache_kv`` over the whole
        stream under ``kv_mask`` (B, S); with this layer's (k, v) buffers,
        written in place, in the mode the module docstring names, under
        the cache's mask."""
        c = self.cfg
        b, s, _ = x.shape
        hd = c.hidden_size // c.num_heads

        def heads(proj, n):
            return cast_linear(x, proj.weight).reshape(b, s, n, hd) \
                .transpose(1, 2)

        q = apply_rope(heads(self.q_proj, c.num_heads), cos, sin)
        k = apply_rope(heads(self.k_proj, c.num_kv_heads), cos, sin)
        v = heads(self.v_proj, c.num_kv_heads)
        prefill = cache_kv is not None and s > 1
        device_index = cache_kv is not None and torch.is_tensor(cache_index)
        vector = device_index and cache_index.dim() == 1
        if vector:
            ck, cv = cache_kv
            rows = torch.arange(b, device=x.device)
            ck[rows, :, cache_index] = k[:, :, 0].to(ck.dtype)
            cv[rows, :, cache_index] = v[:, :, 0].to(cv.dtype)
            k, v = ck, cv
        elif device_index:
            ck, cv = cache_kv
            at = cache_index.view(1)
            ck.index_copy_(2, at, k.to(ck.dtype))
            cv.index_copy_(2, at, v.to(cv.dtype))
            k, v = ck, cv
        elif cache_kv is not None:
            ck, cv = cache_kv
            ck[:, :, cache_index:cache_index + s] = k.to(ck.dtype)
            cv[:, :, cache_index:cache_index + s] = v.to(cv.dtype)
            if not prefill:
                k, v = ck, cv
        rep = c.num_heads // c.num_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)

        # a prefill attends over this call's keys only: it always starts
        # at slot 0, so the cache's first s mask entries are its own
        whole = cache_kv is None or prefill
        amask = kv_mask[:, :s] if whole else kv_mask
        if use_flash and whole and s >= FLASH_MIN_SEQ:
            out = flash_attention(q, k, v, kv_mask=amask, causal=True)
        else:
            sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * hd ** -0.5
            skv = k.shape[2]
            sc = torch.where(amask[:, None, None, :], sc, -1e30)
            qi = torch.arange(s, device=x.device)[:, None]
            kj = torch.arange(skv, device=x.device)[None, :]
            if whole:
                causal = (kj <= qi + (skv - s))[None, None]
            elif vector:
                # rows see only the slots their own stream has written
                causal = (kj[None] <= cache_index[:, None, None])[:, None]
            else:
                # slots are written in order: query (index + i) sees the
                # slots up to its own
                causal = (kj <= qi + cache_index)[None, None]
            p = torch.softmax(torch.where(causal, sc, -1e30), dim=-1)
            out = torch.matmul(p.to(v.dtype).float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, c.num_heads * hd)
        return cast_linear(out, self.o_proj.weight)


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.gate_proj = _linear(c.hidden_size, c.intermediate_size, device,
                                 dtype)
        self.up_proj = _linear(c.hidden_size, c.intermediate_size, device,
                               dtype)
        self.down_proj = _linear(c.intermediate_size, c.hidden_size, device,
                                 dtype)

    def forward(self, h):
        gate = cast_linear(h, self.gate_proj.weight)
        up = cast_linear(h, self.up_proj.weight)
        return cast_linear(F.silu(gate) * up, self.down_proj.weight)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(c, device, dtype)
        self.mlp = LlamaMLP(c, device, dtype)
        self.input_layernorm = RMSNorm(c.hidden_size, device, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, device,
                                                c.rms_norm_eps)

    def forward(self, x, cos, sin, kv_mask, use_flash: bool = False,
                cache_kv=None, cache_index=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, kv_mask,
                               use_flash, cache_kv, cache_index)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """``linear_dtype`` stores the layers' linears in that dtype (None:
    f32, a trainer's master weights); the embedding and the norms stay
    f32."""

    def __init__(self, c: LlamaConfig, device=None, linear_dtype=None):
        super().__init__()
        self.cfg = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         device=device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(c, device, linear_dtype)
                                    for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_size, device, c.rms_norm_eps)

    def forward(self, inputs_embeds, attn_mask, position_ids,
                cache: Optional[dict] = None, use_flash: bool = False):
        """(B, S, H) embeddings, (B, S) validity of these tokens and their
        rope positions -> (the final-normed (B, S, H) hidden states in
        ``cfg.dtype``, the cache).  The embedding lookup is the caller's
        (Groma splices vision tokens into the stream first).  With a
        cache the layers see its whole mask, updated here: a slice at a
        scalar index, one slot a row at a (B,) index; the index then
        advances by S (every row's, as in JAX), in place when it is a
        tensor."""
        c = self.cfg
        cos, sin = rope_tables(position_ids, c.hidden_size // c.num_heads,
                               c.rope_theta)
        x = inputs_embeds.to(torch_dtype(c.dtype))
        s = x.shape[1]
        kv_mask, index = attn_mask, None
        if cache is not None:
            index = cache['index']
            if torch.is_tensor(index):
                if s != 1:
                    raise ValueError('cache index tensors take one token '
                                     'a row')
                if index.dim() == 0:
                    cache['mask'].index_copy_(1, index.view(1),
                                              attn_mask[:, :1])
                else:
                    rows = torch.arange(x.shape[0], device=x.device)
                    cache['mask'][rows, index] = attn_mask[:, 0]
            else:
                max_len = cache['mask'].shape[1]
                if s > 1 and index != 0:
                    raise ValueError('a multi-token call fills a fresh '
                                     'cache (index 0)')
                if index + s > max_len:
                    raise ValueError(f'KV cache overflow: {s} tokens at '
                                     f'slot {index} of a {max_len}-slot '
                                     f'cache')
                cache['mask'][:, index:index + s] = attn_mask[:, :s]
            kv_mask = cache['mask']
        for i, layer in enumerate(self.layers):
            layer_kv = None if cache is None \
                else (cache['k'][i], cache['v'][i])
            x = layer(x, cos, sin, kv_mask, use_flash, layer_kv, index)
        x = self.norm(x)
        if torch.is_tensor(index):
            index.add_(s)
        elif cache is not None:
            cache['index'] = index + s
        return x, cache


class LlamaForCausalLM(nn.Module):
    """LLaMA weights under their HF names; ``model`` holds the trunk's
    forward.  The head stays f32 whatever ``linear_dtype``."""

    def __init__(self, c: LlamaConfig, device=None, linear_dtype=None):
        super().__init__()
        self.model = LlamaModel(c, device, linear_dtype)
        self.lm_head = _linear(c.hidden_size, c.vocab_size, device)
