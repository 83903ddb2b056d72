"""Weights from the seed, made on the card in a few large draws.

Both sides take the same values: the program loads them into its model
before it quantizes, the reference draws them again after the window, in
the same order, and quantizes them itself.  The table of parameter names
and shapes is the Groma checkpoint layout (the reference's names); the
values are drawn in bf16, the type the served weights are stored in,
one ``torch.randn`` per group: the vision side, the embedding table, each
decoder layer, the final norm with the head.  Biases are 0, other 1-D
parameters 1, the embedding tables and the learned tokens N(0, 0.02),
every other weight N(0, 1 / fan_in).
"""

from __future__ import annotations

import math
from typing import Iterator

import torch

SMALL_INIT = ('cls_token', 'position_embeddings',
              'query_position_embeddings.weight', 'embed_tokens.weight',
              'new_input_embs.weight')
LAYER_PREFIX = 'llm.model.layers.'


def group_of(name: str) -> str:
    """The draw a parameter belongs to: 'layer.<i>', 'embed', 'head' or
    'vision' (everything outside the LLM's trunk)."""
    if name.startswith(LAYER_PREFIX):
        return 'layer.' + name[len(LAYER_PREFIX):].split('.')[0]
    if name == 'llm.model.embed_tokens.weight':
        return 'embed'
    if name.startswith('llm.'):
        return 'head'
    return 'vision'


def groups(table: list) -> list:
    """``table`` [(name, shape)] -> [(group, [(name, shape)])] in draw
    order: vision, embed, layer.0 .. layer.L-1, head."""
    by = {}
    for name, shape in table:
        by.setdefault(group_of(name), []).append((name, tuple(shape)))
    layers = sorted((g for g in by if g.startswith('layer.')),
                    key=lambda g: int(g.split('.')[1]))
    order = ['vision', 'embed', *layers, 'head']
    return [(g, by[g]) for g in order if g in by]


def _std(name: str, shape: tuple) -> float:
    if name.endswith(SMALL_INIT):
        return 0.02
    return math.prod(shape[1:]) ** -0.5


def _drawn(name: str, shape: tuple) -> bool:
    return not name.endswith('bias') and len(shape) > 1


def draw(table: list, seed: int, device) -> Iterator[tuple]:
    """Yield (group, {name: bf16 tensor}) in draw order: one randn per
    group on ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for group, params in groups(table):
        n = sum(math.prod(s) for name, s in params if _drawn(name, s))
        flat = torch.randn(n, generator=gen, device=device,
                           dtype=torch.bfloat16) if n else None
        out, at = {}, 0
        for name, shape in params:
            if name.endswith('bias'):
                out[name] = torch.zeros(shape, dtype=torch.bfloat16,
                                        device=device)
            elif len(shape) <= 1:
                out[name] = torch.ones(shape, dtype=torch.bfloat16,
                                       device=device)
            else:
                k = math.prod(shape)
                out[name] = flat[at:at + k].view(shape).mul_(
                    _std(name, shape))
                at += k
        del flat
        yield group, out
