"""Tensor parallelism's collectives inside the model, Megatron style.

The JAX package has no counterpart: there GSPMD inserts the collectives
that ``parallel/mesh.py``'s rules (``_TP_RULES``, ``_VOCAB_RULES``) imply.
Here each rank computes on its own shards (``mesh.shard_model`` cuts
them) and these autograd-aware operators stand where GSPMD's collectives
would:

* ``copy_to_tp``: identity forward, the gradient all-reduced backward.  It
  stands before every column-parallel product, whose input every rank
  holds whole and whose gradient each rank sees only its columns' part of;
* ``reduce_from_tp``: all-reduce forward, identity backward: after a
  row-parallel product, whose ranks each hold a partial sum of the output;
* ``row_parallel_linear``: a row-parallel product.  Each rank's partial sum
  is kept in f32 (one GEMM of the input's dtype that writes f32,
  ``layers.cast_linear(..., out_dtype=)``), the partial sums are reduced
  in f32, and the result is cast once to the input's dtype, so that a tp
  run rounds the output once where a single process does;
* ``vocab_embedding``: a lookup in a table cut on its vocabulary rows: ids
  outside this rank's rows look up row 0 and are zeroed, then the rows are
  summed over the ranks (one rank owns each id, so the sum is exact);
* ``vocab_logits``: a head's whole logits from each rank's columns
  (zero-padded and summed, exact), for the greedy argmax, which then
  breaks ties as a single process does;
* ``row_parallel_quant`` and ``vocab_parallel_logits``: the same two
  for the quantized tree (``mesh.cut_quant_tree``): a quantized product's
  partial sum written in f32 (``ops.quant.int8_matmul`` /
  ``ops.quant4.int4_matmul``'s ``out_dtype``), reduced in f32 and cast
  once; the cut head's logits gathered;
* ``vocab_nll``: the summed NLL of labels under a softmax over vocabulary
  columns cut over the ranks: each rank's logsumexp over its columns,
  gathered and combined, and the gold logit from the rank that owns it.

Every collective is an ``all_reduce`` (sum) over the tp group, which is
what lets a gloo group carry them on CUDA tensors: PyTorch gives gloo only
``broadcast`` and ``all_reduce`` for CUDA.  A bf16 gradient is reduced in
f32 and cast back once.

A head or table kept whole on every rank (its rows do not divide over the
ranks, as the 114 new-token rows at tp = 4) is replicated: every rank
computes it the same from its whole input, outside ``copy_to_tp``, so
that every rank holds its whole gradient (the optimizer's mean over the
tp group then keeps it whole) and adds it once to its input's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from groma_tpu_torch.models.layers import cast_linear


def host_collectives(group) -> bool:
    """Whether ``group``'s collectives run on the host (gloo), where a
    CUDA graph cannot capture them."""
    return group is not None and dist.get_backend(group) == 'gloo'


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in f32 for a narrower float, returned in
    its own dtype (a new tensor)."""
    out = t.to(torch.float32 if t.is_floating_point()
               and t.element_size() < 4 else t.dtype).contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """(..., n) on each rank -> (..., n x tp), rank r's columns at
    [r n, (r + 1) n); backward: this rank's columns of the gradient (the
    consumer is replicated, so every rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        r, tp = dist.get_rank(group), dist.get_world_size(group)
        n = x.shape[-1]
        ctx.cut = (r * n, n)
        full = x.new_zeros((*x.shape[:-1], n * tp))
        full.narrow(-1, r * n, n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, *ctx.cut), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; identity backward."""
    return _ReduceFromTP.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' last dims side by side, in rank order."""
    return _GatherLast.apply(x, group)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor,
                        group) -> torch.Tensor:
    """A row-parallel product: x (..., K/tp) times this rank's (N, K/tp)
    columns of the weight, summed over ``group`` in f32 and cast once to
    x's dtype."""
    return reduce_from_tp(cast_linear(x, w, out_dtype=torch.float32),
                          group).to(x.dtype)


def row_parallel_quant(x: torch.Tensor, qw: dict, group,
                       product) -> torch.Tensor:
    """A row-parallel quantized product: ``product(x, qw,
    out_dtype=torch.float32)``, x (..., K/tp) times this rank's rows of a
    quantized (K, N) leaf, its partial sum in f32, summed over ``group``
    in f32 and cast once to x's dtype, as ``row_parallel_linear`` does
    (no gradient: the quantized tree serves only)."""
    return _all_reduce_f32(product(x, qw, out_dtype=torch.float32),
                           group).to(x.dtype)


def vocab_parallel_logits(local: torch.Tensor, group) -> torch.Tensor:
    """A head's whole logits from this rank's (..., V'/tp) columns of a
    head cut on its vocabulary: the ranks' columns side by side in rank
    order, gathered in f32 (exact) and returned in ``local``'s dtype."""
    return gather_last(local.float(), group).to(local.dtype)


def _cut(local_rows: int, full_rows: int, group) -> Optional[int]:
    """The first row this rank holds of a table cut over ``group``, or None
    where the table is whole on every rank."""
    if group is None or local_rows == full_rows:
        return None
    return dist.get_rank(group) * local_rows


def vocab_embedding(ids: torch.Tensor, weight: torch.Tensor,
                    full_rows: int, group) -> torch.Tensor:
    """``F.embedding(ids, whole table)`` from this rank's rows of a table of
    ``full_rows`` rows (the table itself where it is whole)."""
    start = _cut(weight.shape[0], full_rows, group)
    if start is None:
        return F.embedding(ids, weight)
    local = ids - start
    inside = (local >= 0) & (local < weight.shape[0])
    e = F.embedding(torch.where(inside, local, 0), weight)
    return reduce_from_tp(torch.where(inside[..., None], e, 0.0), group)


def vocab_logits(h: torch.Tensor, w: torch.Tensor, full_cols: int,
                 group) -> torch.Tensor:
    """Whole (..., full_cols) logits ``h @ w.T`` of a (full_cols, H) head
    of which this rank holds ``w``: its rows cut over ``group`` (each
    rank's columns gathered), or the whole head (computed here alone)."""
    if _cut(w.shape[0], full_cols, group) is None:
        return F.linear(h, w.to(h.dtype))
    return gather_last(F.linear(copy_to_tp(h, group), w.to(h.dtype)), group)


def _gold(labels: torch.Tensor, parts) -> torch.Tensor:
    """Each label's logit where one of ``parts`` ((logits, first label
    they hold) pairs) holds it, else 0."""
    gold = labels.new_zeros(labels.shape, dtype=torch.float32)
    for logits, start in parts:
        n = logits.shape[-1]
        mine = (labels >= start) & (labels < start + n)
        at = (labels - start).clamp(0, n - 1)[..., None]
        gold = gold + torch.where(
            mine, torch.gather(logits, -1, at)[..., 0], 0.0)
    return gold


def vocab_nll(h: torch.Tensor, heads: Sequence[torch.Tensor],
              full_cols: Sequence[int], labels: torch.Tensor,
              ok: torch.Tensor, group) -> torch.Tensor:
    """The summed NLL of the ``ok`` positions of ``labels`` under
    softmax(concat_i(h @ heads[i])), each head i given as this rank's
    (H, Vi/tp) columns of a (H, full_cols[i]) head (or the whole head);
    labels index the concatenated vocabulary.  The logits accumulate in
    f32 from h's dtype, as ``ops.fused_ce`` computes them.  The cut
    heads' logsumexp is each rank's over its columns, gathered; a whole
    head's, and its gold logits, every rank's own."""
    dt = h.dtype
    h = h.to(torch.float32)
    # the cut heads' input: its gradient summed in f32 over the ranks
    h_cut = copy_to_tp(h, group)
    cut, whole = [], []     # (logits, the first label they hold)
    base = 0
    for w, n_full in zip(heads, full_cols):
        start = _cut(w.shape[1], n_full, group)
        if start is None:
            whole.append((torch.matmul(h, w.to(dt).float()), base))
        else:
            cut.append((torch.matmul(h_cut, w.to(dt).float()), base + start))
        base += n_full
    lses = [torch.logsumexp(lg, dim=-1, keepdim=True) for lg, _ in whole]
    gold = _gold(labels, whole)
    if cut:
        local = torch.logsumexp(torch.cat([lg for lg, _ in cut], dim=-1),
                                dim=-1, keepdim=True)
        lses.append(gather_last(local, group))
        gold = gold + reduce_from_tp(_gold(labels, cut), group)
    lse = torch.logsumexp(torch.cat(lses, dim=-1), dim=-1)
    return torch.where(ok, lse - gold, 0.0).sum()
