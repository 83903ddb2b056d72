"""The one traffic generator: a workload file's parameters and a seed ->
the requests (prompt layout, image, answer cap) and their arrival times.

Every seed gets the same SET of sizes, and so does every block of
``BLOCK`` consecutive requests: a block's answer caps are the quantiles
of the stated law at evenly spaced levels, its instruction lengths are
evenly spread over their range; the seed only shuffles each block and
draws the token ids and the pixels.  So a window that takes any run of
whole blocks does the same work under every seed, in another order, and
a run's spread is the system's, not the draw's.

An open loop's arrivals are a Poisson process at ``rate`` a second:
independent exponential gaps, drawn once from a fixed seed
(``ARRIVAL_SEED``) for the whole pool and scaled so that the pool's mean
gap is exactly 1 / rate (the gaps of a Poisson process given the time of
its last arrival: a uniform point of the simplex, times that time).
Every run offers the same schedule (the order of the gaps, not only
their set, sets the queue, and so the tails), and a sweep over rates
scales one schedule.

The prompt is Groma's conversation in the fixed stream layout the engine
takes (``max_seq_len`` slots): the system text, the introduction turn
holding the ``<image>`` block (``num_image_tokens`` slots) and the region
block (``max_region_num`` pairs ``<rK>``, ``<region>``), its answer, then
the user's instruction and the assistant's tag.  Text tokens are ids
drawn from the base vocabulary; the model's weights are random, so only
the layout and the lengths matter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

# Groma's added tokens after the base vocabulary, in the order the
# tokenizer adds them: <pad> <sep> ... <image> <region> <rbox> <gbox>
# <rfeat> ..., then <r0> .. <r99>
PAD, IMAGE, REGION = 0, 8, 9
BOX_IDX = 14

# lengths of the fixed text pieces of the conversation template
SYSTEM_TOKENS = 38        # the system prompt up to the first turn
INTRO_BEFORE_IMAGE = 14   # "USER: Here is an image ... Image:"
INTRO_BETWEEN = 3         # ". Regions:"
INTRO_AFTER = 16          # ". ASSISTANT: Thank you ... it?</s>"
USER_TAG = 2              # "USER:"
ASSISTANT_TAG = 3         # "ASSISTANT:"


BLOCK = 16                # requests whose sizes form one stratified set
ARRIVAL_SEED = 0          # the one draw of an open loop's gaps


@dataclass
class Request:
    index: int
    image: np.ndarray         # (H, W, 3) f32, normalized pixels
    input_ids: np.ndarray     # (max_seq_len,) int64
    region_slot: np.ndarray   # (max_seq_len,) int32, -1 outside the block
    valid: np.ndarray         # (max_seq_len,) bool
    max_new: int
    due: float = 0.0          # seconds after the window opens (open loop)


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers evenly spread over [lo, hi]."""
    return np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(int)


def answer_caps(spec: dict, n: int) -> np.ndarray:
    """n answer caps: 'lognormal' (median, sigma, min, max) quantiles at
    evenly spaced levels, or 'uniform' (min, max)."""
    lo, hi = spec['min'], spec['max']
    if spec['law'] == 'uniform':
        return spread(lo, hi, n)
    if spec['law'] != 'lognormal':
        raise ValueError(f"unknown answer law {spec['law']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    caps = np.exp(math.log(spec['median']) + spec['sigma'] * z)
    return np.clip(np.round(caps), lo, hi).astype(int)


def arrival_gaps(spec: dict, n: int) -> np.ndarray:
    """n gaps (s) of an open loop: 'poisson' at ``rate`` a second, the
    same exponential draw for every run, its mean scaled to 1 / rate."""
    if spec['kind'] != 'poisson':
        raise ValueError(f"no gaps for arrivals of kind {spec['kind']!r}")
    unit = np.random.default_rng(ARRIVAL_SEED).standard_exponential(n)
    return unit / (unit.mean() * spec['rate'])


def layout(text: list, base_vocab: int, num_image_tokens: int,
           max_region_num: int, max_seq_len: int) -> tuple:
    """The stream layout: ``text`` is (before image, between, after
    region) id arrays -> (input_ids, region_slot, valid)."""
    before, between, after = text
    regions = np.empty(2 * max_region_num, np.int64)
    regions[0::2] = base_vocab + BOX_IDX + np.arange(max_region_num)
    regions[1::2] = base_vocab + REGION
    ids = np.concatenate([before,
                          np.full(num_image_tokens, base_vocab + IMAGE),
                          between, regions, after]).astype(np.int64)
    if len(ids) > max_seq_len:
        raise ValueError(f'a prompt of {len(ids)} slots does not fit the '
                         f'{max_seq_len}-slot stream')
    slot = np.full(len(ids), -1, np.int32)
    start = len(before) + num_image_tokens + len(between)
    slot[start:start + 2 * max_region_num] = np.repeat(
        np.arange(max_region_num, dtype=np.int32), 2)
    pad = max_seq_len - len(ids)
    valid = np.concatenate([np.ones(len(ids), bool), np.zeros(pad, bool)])
    ids = np.concatenate([ids, np.full(pad, base_vocab + PAD, np.int64)])
    slot = np.concatenate([slot, np.full(pad, -1, np.int32)])
    return ids, slot, valid


class Traffic:
    """A workload's requests for one seed.  ``request(i)`` makes request
    i (its pixels and ids drawn from (seed, i)); the pool of ``pool``
    requests is cycled when a run needs more."""

    def __init__(self, spec: dict, model: dict, seed: int):
        self.spec, self.model, self.seed = spec, model, seed
        pool = spec['pool']
        if pool % BLOCK:
            raise ValueError(f'the pool ({pool}) must be whole blocks of '
                             f'{BLOCK}')
        rng = np.random.default_rng(seed)

        def blocks(one):
            return np.concatenate([rng.permutation(one)
                                   for _ in range(pool // BLOCK)])
        self.caps = blocks(answer_caps(spec['answer'], BLOCK))
        self.instr = blocks(spread(*spec['instruction_tokens'], BLOCK))
        arrivals = spec['arrivals']
        self.gaps = None
        if arrivals['kind'] != 'closed':
            self.gaps = arrival_gaps(arrivals, pool)

    def due(self, i: int) -> float:
        """Request i's due time after the window opens (open loop): the
        sum of the first i gaps, cycled."""
        pool = len(self.gaps)
        whole, part = divmod(i, pool)
        return float(whole * self.gaps.sum() + self.gaps[:part].sum())

    def request(self, i: int) -> Request:
        m = self.model
        base = m['llm']['vocab_size']
        j = i % len(self.caps)
        rng = np.random.default_rng([self.seed, i])
        size = m['image_size']

        def words(n):
            return rng.integers(3, base, n)
        text = (words(SYSTEM_TOKENS + INTRO_BEFORE_IMAGE),
                words(INTRO_BETWEEN),
                words(INTRO_AFTER + USER_TAG + int(self.instr[j])
                      + ASSISTANT_TAG))
        ids, slot, valid = layout(text, base, m['num_image_tokens'],
                                  m['max_region_num'], m['max_seq_len'])
        image = rng.standard_normal((size, size, 3), dtype=np.float32)
        return Request(i, image, ids, slot, valid, int(self.caps[j]),
                       self.due(i) if self.gaps is not None else 0.0)
