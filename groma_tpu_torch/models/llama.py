"""LLaMA pieces shared by the decode paths (counterpart of
``groma_tpu/models/llama.py``).

Ported here: ``rms_norm``, ``rope_tables``, ``apply_rope``,
``make_kv_cache``, and the LLaMA weight modules under their HF state-dict
names (``model.layers.N.self_attn.q_proj.weight`` ...), which the weight
bridge loads and ``llama_quant.quantize_llama_params`` reads.  The bf16
``LlamaModel`` forward belongs to the bf16 ``Generator`` path and is not
ported yet; the served path runs ``llama_quant.quant_llama_forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from groma_tpu.config import LlamaConfig


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
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))


def _linear(i, o, device):
    return nn.Linear(i, o, bias=False, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        hd = c.hidden_size // c.num_heads
        self.q_proj = _linear(c.hidden_size, c.num_heads * hd, device)
        self.k_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device)
        self.v_proj = _linear(c.hidden_size, c.num_kv_heads * hd, device)
        self.o_proj = _linear(c.num_heads * hd, c.hidden_size, device)


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _linear(c.hidden_size, c.intermediate_size, device)
        self.up_proj = _linear(c.hidden_size, c.intermediate_size, device)
        self.down_proj = _linear(c.intermediate_size, c.hidden_size, device)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(c, device)
        self.mlp = LlamaMLP(c, device)
        self.input_layernorm = RMSNorm(c.hidden_size, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, device)


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         device=device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(c, device)
                                    for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_size, device)


class LlamaForCausalLM(nn.Module):
    """LLaMA weights under their HF names (no forward: see the module
    docstring)."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.model = LlamaModel(c, device)
        self.lm_head = _linear(c.hidden_size, c.vocab_size, device)
