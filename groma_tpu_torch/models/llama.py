"""LLaMA (counterpart of ``groma_tpu/models/llama.py``).

Ported here: ``rms_norm``, ``rope_tables``, ``apply_rope``,
``make_kv_cache``, the LLaMA weight modules under their HF state-dict names
(``model.layers.N.self_attn.q_proj.weight`` ...), which the weight bridge
loads and ``llama_quant.quantize_llama_params`` reads, and the training
forward of ``LlamaModel`` without a cache: f32 master weights cast to
``cfg.dtype`` at use, RMSNorm and RoPE in f32 islands, and causal attention
under the stream's key mask, through the flash-attention kernels from
``FLASH_MIN_SEQ`` tokens on (``use_flash``) and the dense path below.  The
cached prefill/decode forward belongs to the bf16 ``Generator`` and is not
ported; the served path runs ``llama_quant.quant_llama_forward``.
"""

from __future__ import annotations

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


def _linear(i, o, device):
    return nn.Linear(i, o, bias=False, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        hd = c.hidden_size // c.num_heads
        self.cfg = c
        self.q_proj = _linear(c.hidden_size, c.num_heads * hd, device)
        self.k_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device)
        self.v_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device)
        self.o_proj = _linear(c.num_heads * hd, c.hidden_size, device)

    def forward(self, x, cos, sin, kv_mask, use_flash: bool = False):
        """Causal self-attention of a whole stream, no cache."""
        c = self.cfg
        b, s, _ = x.shape
        hd = c.hidden_size // c.num_heads

        def heads(proj, n):
            return cast_linear(x, proj.weight).reshape(b, s, n, hd) \
                .transpose(1, 2)

        q = apply_rope(heads(self.q_proj, c.num_heads), cos, sin)
        k = apply_rope(heads(self.k_proj, c.num_kv_heads), cos, sin)
        v = heads(self.v_proj, c.num_kv_heads)
        rep = c.num_heads // c.num_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if use_flash and s >= FLASH_MIN_SEQ:
            out = flash_attention(q, k, v, kv_mask=kv_mask, causal=True)
        else:
            sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * hd ** -0.5
            sc = torch.where(kv_mask[:, None, None, :], sc, -1e30)
            causal = torch.ones((s, s), dtype=torch.bool,
                                device=x.device).tril()
            sc = torch.where(causal, sc, -1e30)
            p = torch.softmax(sc, dim=-1)
            out = torch.matmul(p.to(v.dtype).float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, c.num_heads * hd)
        return cast_linear(out, self.o_proj.weight)


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _linear(c.hidden_size, c.intermediate_size, device)
        self.up_proj = _linear(c.hidden_size, c.intermediate_size, device)
        self.down_proj = _linear(c.intermediate_size, c.hidden_size, device)

    def forward(self, h):
        gate = cast_linear(h, self.gate_proj.weight)
        up = cast_linear(h, self.up_proj.weight)
        return cast_linear(F.silu(gate) * up, self.down_proj.weight)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(c, device)
        self.mlp = LlamaMLP(c, device)
        self.input_layernorm = RMSNorm(c.hidden_size, device, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, device,
                                                c.rms_norm_eps)

    def forward(self, x, cos, sin, kv_mask, use_flash: bool = False):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, kv_mask,
                               use_flash)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.cfg = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         device=device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(c, device)
                                    for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_size, device, c.rms_norm_eps)

    def forward(self, inputs_embeds, attn_mask, position_ids,
                use_flash: bool = False):
        """(B, S, H) embeddings, (B, S) key validity and rope positions ->
        the final-normed (B, S, H) hidden states in ``cfg.dtype``.  The
        embedding lookup is the caller's (Groma splices vision tokens into
        the stream first)."""
        c = self.cfg
        cos, sin = rope_tables(position_ids, c.hidden_size // c.num_heads,
                               c.rope_theta)
        x = inputs_embeds.to(torch_dtype(c.dtype))
        for layer in self.layers:
            x = layer(x, cos, sin, attn_mask, use_flash)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LLaMA weights under their HF names; ``model`` holds the trunk's
    forward."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.model = LlamaModel(c, device)
        self.lm_head = _linear(c.hidden_size, c.vocab_size, device)
