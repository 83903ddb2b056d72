"""The port's continuous-batching engine against the JAX ``BatchEngine``,
and its own serving behaviour.

Against JAX, on the same weights and requests (greedy, 2 slots, 3 requests
so that one is admitted mid-decode): the tokens must be identical, for
(a) int8 weights with a bf16-path (here f32) KV cache, (b) int4 weights
with contiguous int8 KV, (c) int4 weights with paged int8 KV.  The LLM is
a small one whose K values are multiples of 256 (hidden 256, intermediate
768, 2 heads of 128), so its bits=4 tree is really int4.  JAX's int8
attention runs its TPU kernel bodies in interpret mode, the order the
port's plain versions follow.

The rest mirrors ``tests/test_engine.py`` on the port alone, at
``tiny_groma_config()`` with random weights.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
import groma_tpu.ops.paged_attention as j_paged
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.data.tokenizer import StubTokenizer
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.loader import from_jax_params, random_groma
from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
from groma_tpu_torch.serve.engine import BatchEngine

torch.set_num_threads(2)

CFG = tiny_groma_config()
CFG4 = CFG.replace(llm=CFG.llm.replace(hidden_size=256, intermediate_size=768,
                                       num_heads=2, num_kv_heads=2))
MAX_NEW = 6


def _requests(cfg, n, seed=0):
    tok = StubTokenizer(base_vocab=cfg.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        t = build_rec_prompt(f'thing {i}', tok, spec)
        img = rng.standard_normal(
            (cfg.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return tok, reqs


def _serve(engine, reqs, **submit_kw):
    try:
        sessions = [engine.submit(*r, **submit_kw) for r in reqs]
        return [list(s.token_stream()) for s in sessions], sessions
    finally:
        engine.close()


@pytest.fixture(scope='module')
def jax_params():
    model = JGroma(CFG4)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG4)))()['params']
    return model, jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize('bits,kv_bits,paged', [
    (8, 16, False), (4, 8, False), (4, 8, True)])
def test_engine_matches_jax_engine(jax_params, monkeypatch, bits, kv_bits,
                                   paged):
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    monkeypatch.setattr(
        j_paged, 'paged_int8_decode_attention',
        lambda q, kp, ks, vp, vs, t, l: j_paged._call_kernel(
            t, l, q, kp, ks, vp, vs, interpret=True))
    jmodel, params = jax_params
    tok, reqs = _requests(CFG4, 3)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW,
              kv_bits=kv_bits, paged_kv=paged)
    want, _ = _serve(JEngine(jmodel, params, qp=j_quantize(
        params, CFG4, bits=bits), **kw), reqs)
    tmodel = from_jax_params(params, CFG4)
    tqp = quantize_groma_llm(tmodel, CFG4, bits=bits)
    assert tqp['layers'][0]['down_proj']['q'].dtype == (
        torch.uint8 if bits == 4 else torch.int8)
    engine = BatchEngine(tmodel, tqp, **kw)
    got, sessions = _serve(engine, reqs)
    assert got == want
    assert all(len(g) >= 2 for g in got)        # decode ran, not just prefill
    if paged:
        st = engine.stats()
        assert st['free_pages'] == st['total_pages'] and st['truncated'] == 0


# ------------------------------------------------- the port's own behaviour

@pytest.fixture(scope='module')
def tiny():
    model, qp = random_groma(CFG, seed=0)
    tok, reqs = _requests(CFG, 5, seed=1)
    return model, qp, tok, reqs


def _engine(tiny, **kw):
    model, qp, tok, _ = tiny
    args = dict(max_slots=2, max_len=CFG.max_seq_len + MAX_NEW + 8,
                eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW)
    args.update(kw)
    return BatchEngine(model, qp, **args)


def test_paged_matches_contiguous_and_recycles_pages_under_a_tiny_pool(tiny):
    """A pool for ONE worst-case request forces admission back-pressure:
    requests pass through the pool one by one, pages come back, and every
    stream equals the contiguous int8-KV engine's."""
    reqs = tiny[3][:4]
    want, _ = _serve(_engine(tiny, kv_bits=8), reqs)
    for pool in (8 * 128, None):
        engine = _engine(tiny, kv_bits=8, paged_kv=True,
                         kv_pool_tokens=pool or 2 * 128)
        assert engine._np_max == 2
        got, sessions = _serve(engine, reqs)
        assert got == want
        assert not any(s.truncated for s in sessions)
        assert len(engine._free_pages) == engine._num_pages - 1
        assert all(not p for p in engine._slot_pages)


def test_batched_admission_matches_single(tiny):
    """admit_batch=3 with 2 free slots: one padded b=3 prefill program,
    the pad rows never seated."""
    reqs = tiny[3][:4]
    want, _ = _serve(_engine(tiny), reqs)
    got, _ = _serve(_engine(tiny, admit_batch=3), reqs)
    assert got == want


def test_idle_slot_index_stays_in_range(tiny):
    """JAX advances every row's cache index each step, so an idle slot's
    runs past max_len and its writes drop silently; in the port they would
    be out of range.  Slot 1 idles through more decode steps than max_len
    (five requests in a row through slot 0, EOS unreachable), then two
    requests arrive together and both answer as on a fresh engine."""
    model, qp, tok, reqs = tiny
    kw = dict(max_len=CFG.max_seq_len + 64 + 8, max_new_tokens=64, chunk=8,
              eos_id=-1)
    fresh, _ = _serve(_engine(tiny, **kw), reqs[3:5])
    engine = _engine(tiny, **kw)
    try:
        assert engine.max_len == 256
        for r in reqs[:5]:
            assert len(list(engine.submit(*r).token_stream())) == 64
        assert engine.stats()['decode_steps'] > engine.max_len
        assert int(engine._cache['index'][1]) == 0
        late = [engine.submit(*r) for r in reqs[3:5]]
        assert [list(s.token_stream()) for s in late] == fresh
    finally:
        engine.close()


def test_scheduler_thread_runs_in_inference_mode(tiny):
    """Grad mode is thread-local: the scheduler thread enters
    inference_mode itself, so the vision prefill records no graph."""
    model = tiny[0]
    seen = []
    prepare = model.prepare_stream

    def recording(*a, **kw):
        out = prepare(*a, **kw)
        seen.append((torch.is_grad_enabled(), out[0].requires_grad,
                     out[3]['region_tokens'].requires_grad))
        return out
    model.prepare_stream = recording
    try:
        assert any(p.requires_grad for p in model.parameters())
        got, _ = _serve(_engine(tiny), tiny[3][:1])
    finally:
        del model.prepare_stream
    assert got[0] and seen == [(False, False, False)]


def test_priority_orders_admission(tiny):
    engine = _engine(tiny, max_slots=1)
    first_token_at = {}

    def consume(name, sess):
        for _ in sess.token_stream():
            first_token_at.setdefault(name, time.monotonic())
    reqs = tiny[3]
    try:
        s0 = engine.submit(*reqs[0])
        s_low = engine.submit(*reqs[1], priority=0)
        s_high = engine.submit(*reqs[2], priority=5)
        threads = [threading.Thread(target=consume, args=a)
                   for a in (('first', s0), ('low', s_low),
                             ('high', s_high))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        engine.close()
    assert first_token_at['high'] < first_token_at['low'], first_token_at


def test_concurrent_submitters(tiny):
    """More submitting threads than cores under a short switch interval:
    every request is admitted once and finishes, the counters agree, and
    each request gets its greedy tokens whichever slot it shared."""
    engine = _engine(tiny)
    reqs = tiny[3]
    n = (os.cpu_count() or 4) + 2
    outs = [None] * n

    def client(i):
        outs[i] = list(engine.submit(*reqs[i % len(reqs)]).token_stream())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        st = engine.stats()
    finally:
        sys.setswitchinterval(interval)
        engine.close()
    assert st['submitted'] == st['finished'] == n
    assert st['tokens_emitted'] == sum(len(o) for o in outs)
    assert all(outs[i] == outs[i % len(reqs)] for i in range(n))


def test_cancel_frees_the_slot(tiny):
    engine = _engine(tiny, max_slots=1, max_len=CFG.max_seq_len + 208,
                     max_new_tokens=200, eos_id=-1)
    reqs = tiny[3]
    try:
        s0 = engine.submit(*reqs[0])
        stream = s0.token_stream()
        next(stream)
        s0.cancel()
        rest = list(stream)                     # ends: the slot is freed
        assert len(rest) < 199 and s0.done
        got = list(engine.submit(*reqs[1], max_new_tokens=4).token_stream())
        assert len(got) == 4
    finally:
        engine.close()


def test_temperature_rows_leave_greedy_rows_alone(tiny):
    reqs = tiny[3]
    want, _ = _serve(_engine(tiny), reqs[:1])
    engine = _engine(tiny, sample_seed=3)
    try:
        s_greedy = engine.submit(*reqs[0])
        s_hot = engine.submit(*reqs[1], temperature=5.0)
        got_greedy = list(s_greedy.token_stream())
        got_hot = list(s_hot.token_stream())
    finally:
        engine.close()
    assert got_greedy == want[0]
    assert 1 <= len(got_hot) <= MAX_NEW
    assert all(0 <= t < CFG.vocab_size for t in got_hot)


def test_stats_counters(tiny):
    engine = _engine(tiny)
    outs, sessions = _serve(engine, tiny[3][:2])
    st = engine.stats()
    assert st['submitted'] == 2 and st['finished'] == 2
    assert st['truncated'] == 0 and st['active_slots'] == 0
    assert st['tokens_emitted'] == sum(len(o) for o in outs)
    assert st['mean_ttft_sec'] > 0 and all(s.ttft > 0 for s in sessions)
    assert st['tokens_per_sec'] > 0 and st['decode_steps'] > 0
    assert st['decode_ms_per_step'] > 0 and st['nonfinite_logits'] == 0


def test_fatal_error_fails_fast(tiny):
    """A fatal error in the loop ends live and queued streams by re-raising
    it; later submits refuse, and stats() reports it."""
    engine = _engine(tiny, max_slots=1, max_len=CFG.max_seq_len + 72,
                     max_new_tokens=64)
    boom = RuntimeError('CUDA out of memory (simulated)')

    def die():
        raise boom
    engine._decode_burst = die
    reqs = tiny[3]
    try:
        s0 = engine.submit(*reqs[0])
        s1 = engine.submit(*reqs[1])
        with pytest.raises(RuntimeError) as e0:
            list(s0.token_stream())
        assert e0.value.__cause__ is boom
        with pytest.raises(RuntimeError):
            list(s1.token_stream())
        assert s0.error is boom and s1.error is boom and s0.done and s1.done
        assert 'out of memory' in engine.stats()['fatal']
        with pytest.raises(RuntimeError):
            engine.submit(*reqs[2])
    finally:
        engine.close()


def test_unported_options_raise(tiny):
    for kw in ({'prefill_chunk_tokens': 16}, {'spec_lookahead': 2}):
        with pytest.raises(NotImplementedError):
            _engine(tiny, **kw)


def test_w8a8_prefill_matches_jax_engine(jax_params, monkeypatch):
    """int8 weights, the one-shot and the padded b=2 prefill (256 rows, the
    W8A8 route) with ``w8a8_prefill``: JAX's engine's greedy tokens."""
    import groma_tpu_torch.models.llama_quant as llama_quant
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    calls = []
    real = llama_quant.w8a8_matmul

    def counting(*a):
        calls.append((a[0].shape[0], a[1].stride()[0]))
        return real(*a)
    monkeypatch.setattr(llama_quant, 'w8a8_matmul', counting)
    jmodel, params = jax_params
    tok, reqs = _requests(CFG4, 3, seed=2)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW, kv_bits=8,
              admit_batch=2, w8a8_prefill=True)
    want, _ = _serve(JEngine(jmodel, params, qp=j_quantize(params, CFG4),
                             **kw), reqs)
    tmodel = from_jax_params(params, CFG4)
    engine = BatchEngine(tmodel, quantize_groma_llm(tmodel, CFG4), **kw)
    # the K-major copies are made by the constructor, not by a request
    assert len(engine.kmajor) == CFG4.llm.num_layers
    got, _ = _serve(engine, reqs)
    assert got == want
    assert all(len(g) >= 2 for g in got)
    assert calls and all(m >= 256 and stride == 1 for m, stride in calls)


def test_a_prefill_that_raises_ends_the_streams_it_took(tiny):
    """Requests taken off the queue for a prefill that raises are neither
    seated nor queued: each stream must still end, with the error."""
    engine = _engine(tiny, max_slots=2, admit_batch=2)
    boom = RuntimeError('CUDA out of memory (simulated prefill)')

    def die(reqs):
        raise boom
    engine._prefill = die
    reqs = tiny[3]
    ended = {}

    def consume(i, sess):
        try:
            list(sess.token_stream())
            ended[i] = None
        except RuntimeError as e:
            ended[i] = e
    try:
        sessions = [engine.submit(*r) for r in reqs[:3]]
        threads = [threading.Thread(target=consume, args=(i, s), daemon=True)
                   for i, s in enumerate(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), 'a stream hung'
        assert all(isinstance(ended[i], RuntimeError)
                   and ended[i].__cause__ is boom for i in range(3))
        assert all(s.done and s.error is boom for s in sessions)
        assert 'simulated prefill' in engine.stats()['fatal']
        with pytest.raises(RuntimeError):
            engine.submit(*reqs[3])
    finally:
        engine.close()


def test_worker_engine_branch_and_truncated_finish():
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('tiny', device='cpu', quant_type='int4', kv_bits=8,
                         use_engine=True, engine_slots=2, paged_kv=True)
    rng = np.random.default_rng(0)

    def request(max_new):
        return {'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
                'prompt': 'Locate the dog in the image.',
                'max_new_tokens': max_new, 'stream_chunk': 4}
    try:
        frames = list(worker.generate_stream(request(12)))
        assert all(f['error_code'] == 0 for f in frames)
        assert 'boxes' in frames[-1] and 'finish_reason' not in frames[-1]
        status = worker.status()
        assert status['engine']['finished'] == 1
        assert status['queue_length'] == 0
    finally:
        worker.engine.close()
    # a per-request cap of 2 pages and an unreachable EOS: the stream
    # outruns its pages and ends truncated
    old = worker.engine
    worker.engine = BatchEngine(old.model, old.qp, max_slots=1,
                                max_len=CFG.max_seq_len + 8, eos_id=-1,
                                kv_bits=8, paged_kv=True)
    try:
        frames = list(worker.generate_stream(request(250)))
        assert frames[-1]['error_code'] == 0
        assert frames[-1]['finish_reason'] == 'truncated'
        st = worker.engine.stats()
        assert st['truncated'] == 1 and st['free_pages'] == st['total_pages']
    finally:
        worker.engine.close()
