"""Bipartite matching for the DETR losses (counterpart of
``groma_tpu/ops/matcher.py``).

Both matchers take a (B, Q, T) cost and a (B, T) target-validity mask
(valid targets packed at the front) and return, per target slot, the
matched query (int64, -1 on padding), on the cost's device.  Neither is
differentiated: the match is a decision, taken on detached costs.

- ``hungarian_match``: exact, scipy's ``linear_sum_assignment`` on the
  host, as the reference does every step.  One device-to-host copy of the
  costs (the validity mask rides along as one more row) and one copy of
  the assignment back.
- ``auction_match``: the normalized forward auction of the JAX package on
  the tensor's device.  JAX's ``while_loop`` becomes a host loop that reads
  the convergence flag once every ``CHECK_EVERY`` rounds: a round on a
  converged instance changes nothing (no target bids), so rounds past
  convergence only cost time, where each read stalls the host on the
  device.  The ``CHECK_EVERY`` rounds are one CUDA graph over state kept
  per shape (``_Auction``), replayed until the flag clears.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e9
# rounds between two host reads of the auction's convergence flag: a few
# times fewer stalls than rounds, at most CHECK_EVERY - 1 idle rounds
CHECK_EVERY = 16


def _scipy_lsa_batch(cost: np.ndarray, tgt_valid: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment
    b, q, t = cost.shape
    out = np.full((b, t), -1, np.int64)
    for i in range(b):
        nt = int(tgt_valid[i].sum())
        if nt == 0:
            continue
        # valid targets are packed at the front (the collator's contract)
        rows, cols = linear_sum_assignment(cost[i, :, :nt])
        out[i, cols] = rows
    return out


def _finite(cost: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(cost.detach().to(torch.float32), nan=BIG,
                            posinf=BIG, neginf=-BIG)


@torch.no_grad()
def hungarian_match(cost: torch.Tensor,
                    tgt_valid: torch.Tensor) -> torch.Tensor:
    """Exact matching on the host: (B, Q, T), (B, T) -> (B, T) int64."""
    q = cost.shape[1]
    packed = torch.cat([_finite(cost), tgt_valid[:, None, :].to(
        torch.float32)], dim=1).cpu().numpy()
    out = _scipy_lsa_batch(packed[:, :q], packed[:, q] > 0)
    return torch.from_numpy(out).to(cost.device)


class _Auction:
    """The auction's state for one (B, Q, T), ``eps`` and device, kept
    across calls: the scaled benefits, the validity, the prices, the
    owners and the convergence flag, each a static tensor that every call
    overwrites.  ``rounds(k)`` runs k rounds and sets the flag, through a
    ``StepGraph`` (captured once on the card, eager on the CPU)."""

    def __init__(self, b: int, q: int, t: int, eps: float, device):
        f32 = torch.float32
        self.q, self.t, self.eps = q, t, eps
        self.ben = torch.zeros((b, t, q), dtype=f32, device=device)
        self.valid = torch.zeros((b, t), dtype=torch.bool, device=device)
        self.price = torch.zeros((b, q), dtype=f32, device=device)
        self.owner = torch.full((b, t), -1, dtype=torch.int64,
                                device=device)
        self.flag = torch.zeros((), dtype=torch.bool, device=device)
        self.int_max = torch.iinfo(torch.int64).max
        self.tgt_ids = torch.arange(t, device=device).expand(b, t)
        self.q_ids = torch.arange(q, device=device).expand(b, q)
        self.neg_inf = torch.full((b, q), -torch.inf, device=device)
        self.no_winner = torch.full((b, q), self.int_max,
                                    dtype=torch.int64, device=device)
        self.spare = torch.zeros((b, 1), dtype=torch.int64, device=device)
        self.graphs = {}

    def load(self, cost: torch.Tensor, valid: torch.Tensor):
        """A new instance: the benefit scaled to unit range per instance
        over its finite entries, so ``eps`` is relative; no target owns a
        query yet."""
        ben = -_finite(cost).transpose(1, 2)                  # (B, T, Q)
        # the range from finite-magnitude entries of valid targets only:
        # one NaN or inf mapped to BIG would otherwise flatten every
        # difference
        finite = valid[:, :, None] & (ben.abs() < BIG)
        hi = torch.where(finite, ben, -torch.inf).amax(dim=(1, 2))
        lo = torch.where(finite, ben, torch.inf).amin(dim=(1, 2))
        rng = torch.where(finite.any(dim=2).any(dim=1), hi - lo, 0.0)
        self.ben.copy_(ben / rng.clamp(min=1e-30)[:, None, None])
        self.valid.copy_(valid)
        self.price.zero_()
        self.owner.fill_(-1)
        self._set_flag()

    def _set_flag(self):
        self.flag.copy_((self.valid & (self.owner < 0)).any())

    def _round(self):
        q, t, int_max = self.q, self.t, self.int_max
        valid, owner = self.valid, self.owner
        top2_v, top2_i = (self.ben - self.price[:, None, :]).topk(2, dim=-1)
        best_q = top2_i[..., 0]                                # (B, T)
        bidding = valid & (owner < 0)
        bid_val = torch.where(bidding, top2_v[..., 0] - top2_v[..., 1]
                              + self.eps, -torch.inf)
        best_bid = self.neg_inf.scatter_reduce(1, best_q, bid_val, 'amax')
        cand = bidding & (bid_val >= best_bid.gather(1, best_q))
        winner = self.no_winner.scatter_reduce(
            1, best_q, torch.where(cand, self.tgt_ids, int_max), 'amin')
        q_won = winner < int_max
        # release the previous owners of the queries sold again
        owner_q = owner.clamp(0, q - 1)
        release = (owner >= 0) & q_won.gather(1, owner_q) \
            & (winner.gather(1, owner_q) != self.tgt_ids)
        owner = torch.where(release, -1, owner)
        # winners take their queries (a target bids for one query, so it
        # wins at most one); queries nobody won write the spare slot t
        taken = torch.cat([owner, self.spare], 1).scatter(
            1, torch.where(q_won, winner, t), self.q_ids)
        self.owner.copy_(taken[:, :t])
        self.price.add_(torch.where(q_won & torch.isfinite(best_bid),
                                    best_bid, 0.0))

    def rounds(self, k: int):
        """k rounds, then the flag: one replay of k rounds' graph."""
        from groma_tpu_torch.utils.graphs import StepGraph
        if k not in self.graphs:
            def chunk(_):
                for _ in range(k):
                    self._round()
                self._set_flag()
            self.graphs[k] = StepGraph(chunk, {'owner': self.owner})
        self.graphs[k].run(1)


# (B, Q, T, eps, device) -> its _Auction
_auctions: dict = {}


@torch.no_grad()
def auction_match(cost: torch.Tensor, tgt_valid: torch.Tensor,
                  eps: float = 1e-4, num_iters: int = 2000) -> torch.Tensor:
    """Forward auction (minimization), batched: every unassigned valid
    target bids for its best query with increment best - second best +
    eps, the highest bid wins the query (the lowest target among equal
    bids).  The benefit is scaled to unit range per instance over its
    finite entries, so ``eps`` is relative; the total cost lands within
    T * eps * range of the optimum.  (B, Q, T), (B, T) -> (B, T) int64.

    The rounds run CHECK_EVERY at a time as one captured graph on the
    card, replayed while the flag read after it says a valid target is
    still unassigned."""
    b, q, t = cost.shape
    key = (b, q, t, eps, cost.device)
    if key not in _auctions:
        _auctions[key] = _Auction(b, q, t, eps, cost.device)
    auction = _auctions[key]
    auction.load(cost, tgt_valid.to(torch.bool))
    it = 0
    while it < num_iters and bool(auction.flag):
        k = min(CHECK_EVERY, num_iters - it)
        auction.rounds(k)
        it += k
    return torch.where(auction.valid, auction.owner, -1)
