"""The engine's spans and counters (``BatchEngine`` on the CPU, tiny
random weights): each session's span times, on ``time.perf_counter()``
and in order; the queue wait behind a busy slot; the ``stats()`` sums
(admissions, stall time, launch time, mean TTFT) against the sessions
and admissions; the device fields None off the card; and in the chunked
mode, the bursts nested in an admission left out of ``stall_sec``."""

import time

import numpy as np
import pytest
import torch

from groma_tpu_torch.checkpoint.loader import random_groma
from groma_tpu_torch.config import tiny_groma_config
from groma_tpu_torch.data.datasets.base import VLDataSpec
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.rec import build_rec_prompt
from groma_tpu_torch.serve.engine import BatchEngine

torch.set_num_threads(2)

CFG = tiny_groma_config()
MAX_NEW = 6


@pytest.fixture(scope='module')
def tiny():
    model, qp = random_groma(CFG, seed=0)
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=CFG.num_image_tokens,
                      max_region_num=CFG.max_region_num,
                      max_seq_len=CFG.max_seq_len,
                      image_size=CFG.perceiver.image_size)
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(4):
        t = build_rec_prompt(f'thing {i}', tok, spec)
        img = rng.standard_normal(
            (CFG.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return model, qp, reqs


def _engine(tiny, **kw):
    model, qp, _ = tiny
    args = dict(max_slots=2, max_len=CFG.max_seq_len + MAX_NEW + 8,
                eos_id=-1, chunk=2, max_new_tokens=MAX_NEW)
    args.update(kw)
    return BatchEngine(model, qp, **args)


def _submit_timed(engine, req, **kw):
    before = time.perf_counter()
    sess = engine.submit(*req, **kw)
    return sess, before, time.perf_counter()


def test_session_spans_are_in_order_on_the_counter_clock(tiny):
    engine = _engine(tiny)
    try:
        timed = [_submit_timed(engine, r) for r in tiny[2][:3]]
        for sess, _, _ in timed:
            assert len(list(sess.token_stream())) == MAX_NEW
    finally:
        engine.close()
    for sess, before, after in timed:
        assert before <= sess.t_submit <= after
        assert sess.t_submit <= sess.t_admit <= sess.t_first
        assert sess.ttft == sess.t_first - sess.t_submit
        assert sess.prefill_device_ms is None       # no device clock


def test_queue_wait_covers_the_seated_request(tiny):
    """One slot: the second request leaves the queue only once the first
    has ended, so its queue wait is at least the first one's admission."""
    engine = _engine(tiny, max_slots=1)
    try:
        first = engine.submit(*tiny[2][0])
        second = engine.submit(*tiny[2][1])
        list(first.token_stream())
        list(second.token_stream())
    finally:
        engine.close()
    assert second.t_admit - second.t_submit \
        >= first.t_first - first.t_admit > 0
    assert first.done and second.t_admit >= first.t_first


def _timed_admissions(engine):
    """Wrap the engine's admissions: each one's (slot live at its start,
    its first request's ``t_admit``, its last first token, its end)."""
    admissions = []
    admit = engine._admit_group

    def timed(free, group, unseated):
        live = bool(engine._active.any())
        admit(free, group, unseated)
        admissions.append((live, min(r[0].t_admit for r in group),
                           max(r[0].t_first for r in group),
                           time.perf_counter()))
    engine._admit_group = timed
    return admissions


def test_stats_sums_agree_with_the_sessions(tiny):
    engine = _engine(tiny, max_new_tokens=40, max_len=CFG.max_seq_len + 48)
    admissions = _timed_admissions(engine)
    try:
        first = engine.submit(*tiny[2][0])
        stream = first.token_stream()
        next(stream)                  # the others are admitted behind it
        sessions = [first] + [engine.submit(*r, max_new_tokens=MAX_NEW)
                              for r in tiny[2][1:3]]
        list(stream)
        for s in sessions[1:]:
            list(s.token_stream())
        st = engine.stats()
    finally:
        engine.close()
    assert st['admissions'] == 3 == st['finished']
    # the first admission began with no slot live, the second behind it
    assert not admissions[0][0] and admissions[1][0]
    live = [a for a in admissions if a[0]]
    assert sum(f - t for _, t, f, _ in live) <= st['stall_sec'] \
        <= sum(e - t for _, t, _, e in live)
    assert 0 < st['launch_sec'] \
        <= st['decode_ms_per_step'] * st['decode_steps'] / 1e3
    assert st['mean_ttft_sec'] == pytest.approx(
        np.mean([s.ttft for s in sessions]), rel=1e-12)
    assert st['decode_device_sec'] is None          # no device clock


def test_chunked_admission_leaves_its_nested_bursts_out(tiny):
    """A chunked admission while a stream is live runs a burst between
    its chunks: its ``admit`` span holds them, ``stall_sec`` does not."""
    engine = _engine(tiny, prefill_chunk_tokens=16, max_new_tokens=40,
                     max_len=CFG.max_seq_len + 48)
    bursts = []
    burst = engine._decode_burst

    def timed_burst():
        t0 = time.perf_counter()
        burst()
        bursts.append((t0, time.perf_counter()))
    engine._decode_burst = timed_burst
    try:
        first = engine.submit(*tiny[2][0])
        stream = first.token_stream()
        next(stream)
        second = engine.submit(*tiny[2][1], max_new_tokens=2)
        list(second.token_stream())
        list(stream)
        st = engine.stats()
    finally:
        engine.close()
    # the first admission stalls nothing: no slot was live
    span = second.t_first - second.t_admit
    nested = sum(b - a for a, b in bursts
                 if second.t_admit <= a and b <= second.t_first)
    assert nested > 0 and st['admissions'] == 2
    assert span - nested <= st['stall_sec'] < span - nested / 2
