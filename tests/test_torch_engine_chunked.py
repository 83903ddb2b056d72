"""The engine's chunked prefill (``prefill_chunk_tokens``) against the JAX
``BatchEngine``'s, and the worker's ``--prefill-chunk`` /
``--spec-lookahead``.

* Greedy streams equal to JAX's chunked engine's on the same weights,
  requests and stream embeddings (JAX's, see ``shared_stream``): int8
  weights over a float and an int8 cache, int4 weights over a float one
  (contiguous), a ragged chunk (5), one that divides the 128-slot stream
  (32) and one longer than the stream (150); staggered submissions, so
  that chunks interleave with live decode, and ``admit_batch=2``.  JAX's
  int8 decode attention runs its kernel body in interpret mode, as in
  ``test_torch_engine.py``.  (int4 weights over an int8 cache part from
  JAX at a near-tie: the two int4 matmuls round apart, the int8 keys
  amplify it, and one request's last token had a top-2 gap of 8e-4 in
  logits of about 3.)
* The port's chunked engine gives its own one-shot engine's streams over a
  float cache (JAX's invariant), one chunk step a chunk, the trailing
  all-pad chunks skipped.
* A last chunk that would end past ``max_len``: JAX's
  ``dynamic_update_slice`` moves it back over earlier keys and its chunked
  streams leave its one-shot ones; the port's chunk cache covers every
  whole chunk and gives the one-shot streams.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
from groma_tpu_torch.serve.engine import BatchEngine
from tests.test_torch_engine import CFG4, MAX_NEW, _requests, _serve

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def models():
    """(JAX model, params, port model, {bits: (JAX tree, port tree)})."""
    jmodel = JGroma(CFG4)
    p = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                    **_dummy_batch(CFG4)))()['params']
    p = jax.tree_util.tree_map(np.asarray, p)
    tmodel = from_jax_params(p, CFG4)
    trees = {bits: (j_quantize(p, CFG4, bits=bits),
                    quantize_groma_llm(tmodel, CFG4, bits=bits))
             for bits in (8, 4)}
    return jmodel, p, tmodel, trees


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))


@pytest.fixture
def shared_stream(models, monkeypatch):
    """The port's engine takes JAX's stream embeddings for its requests
    (the vision towers agree to about 1e-6, and an int8 KV cache turns
    such differences into flipped key codes, hence tokens parted at
    near-ties): what is held is the LLM side, the chunked prefill."""
    jmodel, params, tmodel, _ = models
    prepare = jax.jit(lambda p, *a: jmodel.apply(
        {'params': p}, *a, method=JGroma.prepare_stream))
    own = tmodel.prepare_stream

    def shared(images, ids, rslot, valid, **kw):
        emb, ids_out, valid_out, vis = own(images, ids, rslot, valid, **kw)
        jemb = prepare(params, *(np.asarray(t) for t in (images, ids,
                                                         rslot, valid)))[0]
        return (torch.from_numpy(np.array(jemb)).to(emb.dtype), ids_out,
                valid_out, vis)
    monkeypatch.setattr(tmodel, 'prepare_stream', shared)


def _staggered(engine, reqs):
    """The first request alone until its first token, then the rest: their
    chunks run between the first one's bursts."""
    try:
        first = engine.submit(*reqs[0])
        stream = first.token_stream()
        head = [next(stream)]
        rest = [engine.submit(*r) for r in reqs[1:]]
        return [head + list(stream)] + [list(s.token_stream())
                                        for s in rest]
    finally:
        engine.close()


@pytest.mark.parametrize('bits,kv_bits,c,staggered,admit', [
    (8, 16, 5, False, 1), (8, 8, 5, True, 1), (8, 8, 32, True, 1),
    (4, 16, 32, True, 1), (8, 16, 150, False, 2)])
def test_chunked_engine_matches_jax_chunked_engine(models, interpret,
                                                   shared_stream, bits,
                                                   kv_bits, c, staggered,
                                                   admit):
    jmodel, params, tmodel, trees = models
    tok, reqs = _requests(CFG4, 3)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW,
              kv_bits=kv_bits, prefill_chunk_tokens=c, admit_batch=admit)
    serve = _staggered if staggered else (lambda e, r: _serve(e, r)[0])
    want = serve(JEngine(jmodel, params, qp=trees[bits][0], **kw), reqs)
    engine = BatchEngine(tmodel, trees[bits][1], **kw)
    got = serve(engine, reqs)
    assert got == want
    assert all(len(g) >= 2 for g in got)
    st = engine.stats()
    assert st['finished'] == 3 and st['nonfinite_logits'] == 0
    # one chunk cache of every whole chunk max_len holds
    assert engine._chunk.state['cache']['mask'].shape[1] == \
        -(-engine.max_len // c) * c


def test_chunked_matches_one_shot_and_skips_pad_chunks(models):
    """Over a float cache the chunked engine's streams are the one-shot
    engine's; each request runs last_idx // c + 1 chunk steps, one
    StepGraph step each, and bursts run between a late request's chunks."""
    _, _, tmodel, trees = models
    tok, reqs = _requests(CFG4, 3, seed=4)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=-1, chunk=2, max_new_tokens=MAX_NEW)
    want, _ = _serve(BatchEngine(tmodel, trees[8][1], **kw), reqs)
    engine = BatchEngine(tmodel, trees[8][1], prefill_chunk_tokens=5, **kw)
    events = []
    step, burst = engine._chunk_step, engine._decode_burst

    def counted_step(st):
        events.append('chunk')
        step(st)

    def counted_burst():
        events.append('burst')
        burst()
    engine._chunk_step = counted_step
    engine._decode_burst = counted_burst
    try:
        got = _staggered(engine, reqs)
    finally:
        del engine._chunk_step, engine._decode_burst
    assert got == want
    n = [int(np.nonzero(r[3])[0][-1]) // 5 + 1 for r in reqs]
    chunks = [i for i, e in enumerate(events) if e == 'chunk']
    assert len(chunks) == sum(n)
    # the second request's chunks interleave with the first one's bursts
    second = chunks[n[0]:n[0] + n[1]]
    assert 'burst' in events[second[0]:second[-1]]


def _long_requests(n, seed=0):
    """REC prompts of 120 and more words in a 240-slot stream: their last
    valid token near slot 200."""
    tok = StableStubTokenizer(base_vocab=CFG4.llm.vocab_size,
                              model_max_length=512)
    spec = VLDataSpec(num_image_tokens=CFG4.num_image_tokens,
                      max_region_num=CFG4.max_region_num, max_seq_len=240,
                      image_size=CFG4.perceiver.image_size)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        t = build_rec_prompt(' '.join(f'word{j}' for j in range(120 + i)),
                             tok, spec)
        img = rng.standard_normal(
            (CFG4.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return tok, reqs


def test_last_chunk_past_max_len(models):
    """max_len 256 and chunks of 150 over streams whose last valid token
    is near slot 200: two chunks, 300 slots.  JAX writes the second chunk
    at 106 instead of 150 (its cache is 256 long), so its chunked streams
    depart from its one-shot streams (a fault of the reference, pinned
    here); the port's chunk cache holds 300 slots, of which the first 256
    are seated, and its streams are the one-shot ones, JAX's too, as they
    are with one chunk of 300."""
    jmodel, params, tmodel, trees = models
    tok, reqs = _long_requests(2)
    last = [int(np.nonzero(r[3])[0][-1]) for r in reqs]
    assert all(150 <= i < 240 for i in last)
    kw = dict(max_slots=2, max_len=240 + MAX_NEW + 8, eos_id=tok.sp.eos,
              chunk=2, max_new_tokens=MAX_NEW)
    jqp, tqp = trees[8]
    j_one, _ = _serve(JEngine(jmodel, params, qp=jqp, **kw), reqs)
    j_chunked, _ = _serve(JEngine(jmodel, params, qp=jqp,
                                  prefill_chunk_tokens=150, **kw), reqs)
    engine = BatchEngine(tmodel, tqp, prefill_chunk_tokens=150, **kw)
    assert engine.max_len == 256
    got, _ = _serve(engine, reqs)
    t_one, _ = _serve(BatchEngine(tmodel, tqp, **kw), reqs)
    assert got == t_one == j_one
    assert j_chunked != j_one
    assert engine._chunk.state['cache']['mask'].shape[1] == 300
    # one chunk longer than max_len (JAX's trace of it fails in _admit)
    longer = BatchEngine(tmodel, tqp, prefill_chunk_tokens=300, **kw)
    assert _serve(longer, reqs)[0] == t_one


def test_worker_flags_reach_the_engine(monkeypatch):
    """``--prefill-chunk`` and ``--spec-lookahead`` parse and reach the
    worker's engine (tiny, on the CPU), and the chunked engine serves."""
    import sys

    from groma_tpu_torch.serve import worker as worker_mod
    made = {}

    class Server:
        def __init__(self, address, handler):
            made['address'] = address

        def serve_forever(self):
            pass

    def handler(worker):
        made['worker'] = worker
        return None
    monkeypatch.setattr(worker_mod, 'ThreadingHTTPServer', Server)
    monkeypatch.setattr(worker_mod, 'make_handler', handler)
    monkeypatch.setattr(sys, 'argv', [
        'worker', '--tiny', '--device', 'cpu', '--engine', '--engine-slots',
        '2', '--quant_type', 'int8', '--kv-bits', '8', '--prefill-chunk',
        '16', '--spec-lookahead', '2', '--port', '0'])
    worker_mod.main()
    worker = made['worker']
    engine = worker.engine
    try:
        assert engine.prefill_chunk_tokens == 16
        assert engine.spec_lookahead == 2
        base = worker.cfg.max_seq_len + worker_mod.ENGINE_MAX_NEW_TOKENS + 8
        assert engine.max_len == -(-(-(-base // 128) * 128 + 2) // 128) * 128
        frames = list(worker.generate_stream({
            'image': np.random.default_rng(0).standard_normal(
                (56, 56, 3)).astype(np.float32),
            'prompt': 'Locate the dog.', 'max_new_tokens': 5,
            'stream_chunk': 2}))
        assert all(f['error_code'] == 0 for f in frames)
        assert 'boxes' in frames[-1]
        st = engine.stats()
        assert st['finished'] == 1 and st['tokens_emitted'] >= 1
        assert engine._chunk is not None
    finally:
        engine.close()


def test_chunked_engine_survives_concurrent_submitters(models):
    """Chunked admissions under concurrent submitters: every request
    finishes once with its one-shot stream."""
    _, _, tmodel, trees = models
    tok, reqs = _requests(CFG4, 3, seed=5)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW)
    want, _ = _serve(BatchEngine(tmodel, trees[8][1], **kw), reqs)
    engine = BatchEngine(tmodel, trees[8][1], prefill_chunk_tokens=7, **kw)
    outs = [None] * 6

    def client(i):
        time.sleep(0.01 * i)
        outs[i] = list(engine.submit(*reqs[i % 3]).token_stream())
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        st = engine.stats()
    finally:
        engine.close()
    assert outs == want + want
    assert st['submitted'] == st['finished'] == 6
