"""Chunked cross-entropy over a large vocabulary (counterpart of
``groma_tpu/ops/fused_ce.py``).

The full (B, S, V) logits are never held: the stream is cut into chunks of
``chunk`` positions, each chunk's logits are formed, reduced to logsumexp
minus the gold logit, and dropped; the backward forms them again, one chunk
at a time (``torch.utils.checkpoint``).  Numerics as in the JAX package:
the heads are cast to the hidden states' dtype and the logits accumulate in
f32 (products of bf16 values summed in f32).  The JAX package runs no
Pallas kernel here, so neither does the port.

Under tensor parallelism (``group``) each head is this rank's columns of
a head cut on its vocabulary (or the whole head, where tp does not divide
it), and each chunk's NLL is ``parallel/tensor_parallel.vocab_nll``:
local logsumexps gathered, the gold logit from the rank that owns it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from groma_tpu_torch.parallel.tensor_parallel import vocab_nll


def _chunk_nll(h, labels, ok, *heads):
    """Summed NLL of one (B, chunk) slab."""
    logits = torch.cat([torch.matmul(h.float(), w.to(h.dtype).float())
                        for w in heads], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.where(ok, lse - gold, 0.0).sum()


def fused_cross_entropy(hidden: torch.Tensor, heads: Sequence[torch.Tensor],
                        labels: torch.Tensor, ok: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    """Mean NLL of ``labels`` under softmax(concat_i(hidden @ heads[i])).

    hidden: (B, S, H), already gathered to the conditioning positions.
    heads:  (H, Vi) projections (Groma's dual head); labels index the
            concatenated [0, sum Vi) vocabulary.
    labels: (B, S) int; ok: (B, S) bool, the positions in the mean."""
    return fused_nll_sum(hidden, heads, labels, ok, chunk) \
        / ok.sum().clamp(min=1)


def fused_nll_sum(hidden: torch.Tensor, heads: Sequence[torch.Tensor],
                  labels: torch.Tensor, ok: torch.Tensor,
                  chunk: int = 256, group=None,
                  full_cols: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The summed NLL of the ``ok`` positions (``fused_cross_entropy``
    before its division by their count).  ``group``: the tp group the
    heads' columns are cut over, ``full_cols`` each head's whole width."""
    labels = torch.where(ok, labels, 0).long()
    total = hidden.new_zeros((), dtype=torch.float32)
    if group is None:
        nll = _chunk_nll
    else:
        def nll(h, lab, k, *hs):
            return vocab_nll(h, hs, full_cols, lab, k, group)
    for start in range(0, hidden.shape[1], chunk):
        sl = slice(start, start + chunk)
        args = (hidden[:, sl], labels[:, sl], ok[:, sl], *heads)
        if torch.is_grad_enabled():
            total = total + checkpoint(nll, *args, use_reentrant=False)
        else:
            total = total + nll(*args)
    return total
