"""Weights for the port (counterpart of ``groma_tpu/checkpoint/loader.py``).

The bridge from the JAX package: its ``hf_export.export_groma`` turns a
JAX ``GromaModel`` param tree (numpy arrays) into the reference's torch
state dict (every Dense/conv/convT transpose and the flatten permutation
done, round-trip tested there), and the port's modules, which carry the
reference's parameter names, take it with ``load_state_dict(strict=True)``.
A released checkpoint directory goes through the JAX package's jax-free
``import_groma`` first, then the same bridge.

``random_groma`` builds any ``GromaConfig`` with random weights from a
seed directly on the target device, and quantizes the LLM one layer at a
time so its full-precision copy never exists at once; ``random_groma_full``
keeps every weight in f32, for training.  ``full_precision=True`` loads a
model for training: f32 master weights everywhere (the JAX package's
params), the ViT and region encoder still computing in their config dtype.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from groma_tpu.config import GromaConfig, tiny_groma_config
from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama_quant import (quantize_head,
                                                quantize_llama_layer)

QUANT_BITS = {'bf16': 16, 'int8': 8, 'int4': 4}   # --quant_type -> bits
_SMALL_INIT = ('cls_token', 'position_embeddings',
               'query_position_embeddings.weight', 'embed_tokens.weight',
               'new_input_embs.weight')


def from_state_dict(sd: dict, cfg: GromaConfig, device=None,
                    full_precision: bool = False) -> GromaModel:
    """Reference-format Groma state dict (name -> numpy array) -> the
    port's GromaModel, each tensor in its module's dtype."""
    model = GromaModel(cfg, device='meta', full_precision=full_precision)
    want = model.state_dict()
    tensors = {k: torch.from_numpy(np.array(v)).to(
                   device=device, dtype=want[k].dtype)
               for k, v in sd.items() if k in want}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.eval()


def from_jax_params(params: dict, cfg: GromaConfig, device=None,
                    full_precision: bool = False):
    """JAX GromaModel params (a tree of numpy arrays) -> GromaModel."""
    from groma_tpu.checkpoint.hf_export import export_groma
    return from_state_dict(export_groma(params, cfg), cfg, device,
                           full_precision)


def load_groma(path: str, device=None, full_precision: bool = False):
    """A reference-format checkpoint directory (config.json with
    llm_cfg/perceiver_cfg + safetensors or .bin) -> (GromaModel, cfg)."""
    from groma_tpu.checkpoint.hf_import import load_state_dict
    from groma_tpu.checkpoint.loader import hf_groma_config, import_groma
    with open(os.path.join(path, 'config.json')) as f:
        cfg_d = json.load(f)
    if 'config_type' in cfg_d:
        raise ValueError(f'{path} is an orbax checkpoint of the JAX package; '
                         'export it with groma_tpu.checkpoint.hf_export '
                         'first')
    cfg = hf_groma_config(cfg_d)
    params = import_groma(load_state_dict(path), cfg)
    return from_jax_params(params, cfg, device, full_precision), cfg


@torch.no_grad()
def _fill(module: torch.nn.Module, gen: torch.Generator, prefix: str = ''):
    """Random init in place: biases 0, 1-D scales 1, embeddings N(0, 0.02),
    other weights N(0, 1/fan_in)."""
    for name, p in module.named_parameters(prefix=prefix):
        if name.endswith('bias'):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            std = 0.02 if name.endswith(_SMALL_INIT) \
                else p[0].numel() ** -0.5
            p.normal_(0.0, std, generator=gen)


@torch.no_grad()
def random_groma(cfg: GromaConfig, seed: int = 0, device='cpu',
                 bits: int = 8):
    """Random weights from ``seed`` for any config, made on ``device``.
    Returns (GromaModel, qp): the LLM lives only in qp, quantized with
    ``bits`` (8, 4 or 16; the model's ``llm`` keeps just its embedding
    table, for prefill)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GromaModel(cfg, device='meta')
    for name, child in model.named_children():
        if name != 'llm':
            child.to_empty(device=device)
            _fill(child, gen, prefix=name)
    llm = model.llm
    llm.model.embed_tokens.to_empty(device=device)
    _fill(llm.model.embed_tokens, gen, prefix='embed_tokens')
    qp = {'layers': []}
    for layer in llm.model.layers:
        layer.to_empty(device=device)
        _fill(layer, gen)
        qp['layers'].append(quantize_llama_layer(layer.state_dict(), bits))
        layer.to_empty(device='meta')
    llm.model.norm.to_empty(device=device)
    _fill(llm.model.norm, gen)
    qp['norm'] = llm.model.norm.weight
    llm.lm_head.to_empty(device=device)
    _fill(llm.lm_head, gen)
    qp['lm_head'] = quantize_head(llm.lm_head.weight, bits)
    llm.lm_head.to_empty(device='meta')
    qp['embed_tokens'] = llm.model.embed_tokens.weight.to(torch.bfloat16)
    qp['new_input_embs'] = model.new_input_embs.weight.to(torch.bfloat16)
    qp['extra_lm_head'] = model.extra_lm_head.weight.T.to(torch.bfloat16)
    return model.eval(), qp


@torch.no_grad()
def random_groma_full(cfg: GromaConfig, seed: int = 0, device='cpu'):
    """Random weights from ``seed`` for any config, every one kept in f32
    on ``device`` (a trainer's master weights)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GromaModel(cfg, device='meta', full_precision=True)
    model.to_empty(device=device)
    _fill(model, gen)
    return model


def load_quantized(model_dir: str, device=None, seed: int = 0,
                   bits: int = 8):
    """'tiny' (random tiny config), 'random' (random full-width
    GromaConfig) or a checkpoint directory -> (GromaModel, qp, cfg), the
    LLM quantized with ``bits`` (8, 4 or 16)."""
    from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
    if model_dir in ('tiny', 'random'):
        cfg = tiny_groma_config() if model_dir == 'tiny' else GromaConfig()
        model, qp = random_groma(cfg, seed=seed, device=device or 'cpu',
                                 bits=bits)
        return model, qp, cfg
    model, cfg = load_groma(model_dir, device)
    return model, quantize_groma_llm(model, cfg, bits), cfg
