"""Prompt-lookup speculative decoding, greedy and draft-model-free
(counterpart of ``groma_tpu/eval/speculative.py``).

Decode at B=1 streams every weight once per token, so verifying G+1
tokens in one forward costs about what one token does: if a cheap proposer
guesses the next G tokens, each accepted run emits several tokens for one
weight stream.  The proposer is prompt lookup (the context's trailing
n-gram matched against its earlier occurrences).  The greedy tokens are
exactly those of sequential greedy decoding.

The verify step is JAX's jitted ``verify`` as one captured CUDA graph
(``utils.graphs.StepGraph``) over static device state, ``Verifier``: the
current token, the draft, the position, the cache with its 0-d index, and
the outputs.  A step feeds ``[cur, d_1..d_G]`` through the scalar-index
chunked append of ``quant_llama_forward``, takes the greedy argmax of each
position, accepts the draft's longest agreeing prefix (n_accept = the sum
of the cumulative product of the matches), pads the emitted tokens with
the last greedy one, and rewinds the cache exactly: the mask is cleared on
the rejected slots ``[keep, index0 + 1 + G)`` and the index set to
``keep = index0 + 1 + n_accept`` (the next append overwrites those slots).
Everything is written in place, since a replay never sees a rebound name.
The host writes the draft before each step and reads the emitted tokens
and n_accept back once after it, as JAX's loop does.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from groma_tpu_torch.models.llama import fresh_cache
from groma_tpu_torch.models.llama_quant import quant_llama_forward
from groma_tpu_torch.utils.graphs import StepGraph


def propose_prompt_lookup(context: Sequence[int], G: int,
                          ngram: int = 2) -> List[int]:
    """Draft G tokens: what followed the most recent earlier occurrence of
    the context's trailing ``ngram``, padded with the last token; with no
    match, the last token G times."""
    ctx = list(context)
    if len(ctx) >= ngram + 1:
        key = ctx[-ngram:]
        for i in range(len(ctx) - ngram - 1, -1, -1):
            if ctx[i:i + ngram] == key:
                cont = ctx[i + ngram:i + ngram + G]
                if cont:
                    return (cont + [ctx[-1]] * G)[:G]
    return [ctx[-1]] * G


def verify_step(st: dict, qp: dict, cfg_llm, G: int, embed_fn, logits_fn):
    """One verify over the state ``st`` (see ``Verifier``), in place."""
    dev = st['cur'].device
    toks = torch.cat([st['cur'], st['draft']])[None]         # (1, G+1)
    steps = torch.arange(G + 1, device=dev)
    index0 = st['cache']['index'].clone()
    hidden, _ = quant_llama_forward(
        qp, cfg_llm, embed_fn(qp, toks),
        torch.ones((1, G + 1), dtype=torch.bool, device=dev),
        st['pos0'][:, None] + steps[None], st['cache'], chunked=True)
    greedy = torch.argmax(logits_fn(qp, hidden)[0], dim=-1)  # (G+1,)
    match = (greedy[:-1] == st['draft']).long()
    n_accept = torch.cumprod(match, dim=0).sum()
    # index_select, not greedy[n_accept]: a 0-d index is read on the host
    st['emitted'].copy_(greedy.index_select(0, torch.minimum(steps,
                                                            n_accept)))
    st['n_accept'].copy_(n_accept)
    keep = index0 + 1 + n_accept
    slots = torch.arange(st['cache']['mask'].shape[1], device=dev)
    rejected = (slots >= keep) & (slots < index0 + 1 + G)
    st['cache']['mask'].logical_and_(~rejected[None])
    st['cache']['index'].copy_(keep)
    st['cur'].copy_(greedy.index_select(0, n_accept.view(1)))
    st['pos0'].add_(n_accept + 1)


class Verifier:
    """The verify step of one batch-1 generator over its static state,
    kept across generations as a compiled JAX program is: ``cache`` (one
    row, ``max_len`` slots, its index a 0-d int64 tensor while verifying),
    ``cur`` (1,), ``draft`` (G,), ``pos0`` (1,), and the outputs
    ``emitted`` (G+1,) and ``n_accept`` (0-d).  ``cache()`` hands the cache
    to a prefill (mask cleared, index 0), ``begin`` loads the prefill's
    first token and position, and each call verifies one draft.
    ``eager``: never capture the step (a tree cut over a gloo tp group,
    whose collectives run on the host)."""

    def __init__(self, qp: dict, cfg_llm, cache: dict, G: int, embed_fn,
                 logits_fn, eager: bool = False):
        self.G = G
        self._cache = cache
        dev = cache['mask'].device
        self._index = torch.zeros((), dtype=torch.int64, device=dev)
        self.state = {
            'cache': cache,
            'cur': torch.zeros(1, dtype=torch.int64, device=dev),
            'draft': torch.zeros(G, dtype=torch.int64, device=dev),
            'pos0': torch.zeros(1, dtype=torch.int64, device=dev),
            'emitted': torch.zeros(G + 1, dtype=torch.int64, device=dev),
            'n_accept': torch.zeros((), dtype=torch.int64, device=dev)}
        self.graph = StepGraph(
            lambda st: verify_step(st, qp, cfg_llm, G, embed_fn, logits_fn),
            self.state, eager=eager)

    def cache(self) -> dict:
        return fresh_cache(self._cache)

    def begin(self, cur: int, pos0: int):
        """After the prefill filled ``cache()``: its index onto the device
        word, the first token and the next position into the state."""
        st = self.state
        self._index.fill_(self._cache['index'])
        self._cache['index'] = self._index
        st['cur'].fill_(cur)
        st['pos0'].fill_(pos0)

    def __call__(self, draft: Sequence[int]):
        """Verify one draft of G tokens -> (emitted tokens (G+1,) as a
        numpy array, n_accept): one copy in, one step, one read-back."""
        st = self.state
        st['draft'].copy_(torch.as_tensor(list(draft), dtype=torch.int64))
        self.graph.run(1)
        back = torch.cat([st['emitted'], st['n_accept'].view(1)]).cpu()
        back = back.numpy()
        return back[:-1], int(back[-1])


def speculative_greedy_decode(verify, cur: int, context: List[int],
                              max_new: int, eos_id: int, G: int,
                              ngram: int = 2, proposer=None):
    """Host loop: propose, verify, accept until ``max_new`` tokens or EOS.

    ``verify(draft) -> (emitted, n_accept)`` (a started ``Verifier``);
    ``cur`` is the prefill's greedy token and ``context`` the prompt's valid
    token ids, which emitted tokens extend so that later drafts can match
    generated text.  Returns (tokens, stats): verify_calls, accepted (per
    call) and tokens_per_call."""
    out: List[int] = [cur]
    context = list(context) + [cur]
    accepts: List[int] = []
    proposer = proposer or propose_prompt_lookup
    while len(out) < max_new and out[-1] != eos_id:
        emitted, n_acc = verify(proposer(context, G, ngram))
        accepts.append(n_acc)
        for t in emitted[:n_acc + 1]:
            t = int(t)
            out.append(t)
            context.append(t)
            if t == eos_id or len(out) >= max_new:
                break
    stats = {'verify_calls': len(accepts),
             'accepted': accepts,
             'tokens_per_call': round(len(out[1:]) / max(len(accepts), 1),
                                      2)}
    return out, stats
