"""The prefills as captured CUDA graphs (``utils.graphs.CallGraph``, the
counterpart of ``jax.jit``'s cache of compiled programs), on the CPU.

* The helper: eager on the CPU; through a CPU stand-in for the CUDA graph
  API (``fake_card``: a capture records the call, a replay makes it again
  on the static inputs, writes the results into the capture's outputs and
  undoes what the call did on the host, as a real replay does nothing
  there), a graph per key (the owner's flags, the state object, every
  input's shape and dtype), one warm-up and one capture a key, every later
  call a replay into the same outputs, the least recent key dropped past
  ``keep``, launches counted as ``StepGraph`` counts them; every
  wrapper's launch counter (the flash backward's by mask too) read and
  written back by name, and a replayed flash backward counted.
* A capture-safety guard (``host_guard.py``): each graphed prefill body
  runs with the host reads (``Tensor.item``, ``.cpu``, ``.tolist``,
  ``.numpy``, ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
  ``torch.nonzero``) and host data sent to a device (``torch.tensor`` /
  ``as_tensor`` with a device, a Python number written with
  ``__setitem__``) refused: the ``QuantGenerator`` (int8 + kv8, int4, W8A8 + ``vision_int8`` +
  ``use_flash``), the ``Generator`` (scan and loop), the engine's
  ``prefill_one`` at b = 1 and 2 with and without a quantized tree, and
  the chunked prefill's ``prepare_one`` and ``last_logits``.
* Through ``fake_card``, two calls of one key (the second a replay): the
  generators' and engines' greedy tokens equal JAX's, their first logits
  and selected boxes within the tolerances of ``test_torch_generator.py``
  / ``test_torch_w8a8.py`` of JAX's jitted prefill, and the cache's index
  after the prefill is the stream's length S.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate import Generator as JGenerator
from groma_tpu.eval.generate_quant import QuantGenerator as JQuantGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.serve.engine import BatchEngine as JEngine
import groma_tpu_torch.models.llama_quant as llama_quant
import groma_tpu_torch.models.region_encoder as region_encoder
from groma_tpu_torch.checkpoint.loader import (from_jax_params, random_groma,
                                               random_groma_unquantized)
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.generate import DecodeScan, Generator
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quantize_groma_llm)
from groma_tpu_torch.ops.flash_attention import flash_bwd
from groma_tpu_torch.ops.quant import int8_matmul
from groma_tpu_torch.serve.engine import BatchEngine
from groma_tpu_torch.utils import graphs
from groma_tpu_torch.utils.graphs import (CallGraph, StepGraph,
                                          launch_counts, set_launch_counts)
from host_guard import no_host_reads

torch.set_num_threads(2)

CFG = tiny_groma_config(box_score_thres=0.0)
CFG4 = CFG.replace(llm=CFG.llm.replace(hidden_size=256, intermediate_size=768,
                                       num_heads=2, num_kv_heads=2))
MAX_NEW = 6
F32_TOL = 2e-5       # test_torch_generator.py's, the f32 path's logits
QUANT_TOL = 1e-4     # test_torch_w8a8.py's, the quantized path's
BOX_TOL = 1e-5
# the quantized engines' first logits against JAX's, x max|JAX's|: the
# eager port reads up to 1.0e-4 (one-shot) and 1.4e-3 (chunked, the chunk
# appends over a dequantized cache) at these prompts; a bf16 unit flipped
# upstream of the head moves them by about 1e-4
ENGINE_REL_TOL = {'one-shot': 1e-3, 'chunked': 3e-3}


def _prompts(cfg, n, seed=0):
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
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


def _batch(reqs):
    return tuple(np.stack([r[i] for r in reqs]) for i in range(4))


@pytest.fixture(scope='module')
def params():
    model = JGroma(CFG)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG)))()['params']
    return model, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope='module')
def params4():
    model = JGroma(CFG4)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG4)))()['params']
    return model, jax.tree_util.tree_map(np.asarray, p)


# ------------------------------------------ a CPU stand-in for the card


class _FakeStream:
    def wait_stream(self, other):
        pass


def _host_values(tree, out=None, path=()):
    """The non-tensor leaves of a state's dicts, by path."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, dict):
                _host_values(v, out, path + (k,))
            elif not torch.is_tensor(v) and not isinstance(v, list):
                out[path + (k,)] = v
    return out


def _restore_host(tree, values):
    for path, v in values.items():
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = v


class _FakeGraph:
    """A CUDA graph as the CPU plays it: ``call`` is the captured call, a
    replay makes it again on the static inputs, writes the results into
    the capture's outputs and puts back the state's host values and the
    launch counters (a replay runs on the device only)."""
    recording = None
    made = []

    def __init__(self):
        self.call = None
        _FakeGraph.made.append(self)

    def replay(self):
        fn, state, inputs, outputs = self.call
        host, counts = _host_values(state), launch_counts()
        new = fn(state, *inputs)
        _restore_host(state, host)
        set_launch_counts(counts)
        for dst, src in zip(graphs._tensors(outputs), graphs._tensors(new)):
            dst.copy_(src)


@contextlib.contextmanager
def _fake_capture(graph, **_):
    _FakeGraph.recording = graph
    try:
        yield
    finally:
        _FakeGraph.recording = None


@pytest.fixture
def fake_card(monkeypatch):
    """CallGraph captures CPU calls through _FakeGraph -> the graphs made."""
    _FakeGraph.made = []
    monkeypatch.setattr(graphs, '_on_card', lambda t: True)
    monkeypatch.setattr(graphs, 'capture_stream', lambda d: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda d=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: object())
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph', _fake_capture)
    run = CallGraph.run

    def recording_run(self, fn, state, *inputs, key=()):
        def recorded(st, *args):
            out = fn(st, *args)
            if _FakeGraph.recording is not None:
                _FakeGraph.recording.call = (fn, st, args, out)
            return out
        return run(self, recorded, state, *inputs, key=key)
    monkeypatch.setattr(CallGraph, 'run', recording_run)
    return _FakeGraph.made


# ------------------------------------------------------------ the helper


def _doubling(calls):
    """A call that counts itself, writes its input's sum into the state and
    returns twice its input, one int8_matmul launch counted."""
    def fn(st, x):
        calls.append(x.shape)
        st['sum'].copy_(x.sum())
        st['index'] = x.shape[0]            # a host value
        int8_matmul.launches += 1
        return {'twice': x * 2}
    return fn


def test_call_graph_runs_eagerly_on_the_cpu():
    calls, st = [], {'sum': torch.zeros(())}
    g = CallGraph()
    for n in (3, 3, 4):
        x = torch.arange(n, dtype=torch.float32)
        out = g.run(_doubling(calls), st, x, key=('k',))
        assert torch.equal(out['twice'], x * 2) and st['index'] == n
    assert calls == [(3,), (3,), (4,)]
    assert g.mode == 'eager' and not g.entries
    assert CallGraph(eager=True).run(lambda s, x: x + 1, None,
                                     torch.ones(1)).item() == 2.0


def test_call_graph_keys_replays_into_its_outputs(fake_card):
    calls, st = [], {'sum': torch.zeros(())}
    fn = _doubling(calls)
    g = CallGraph()
    StepGraph.reset_tally()
    counts = launch_counts()
    set_launch_counts(dict.fromkeys(counts, 0))
    try:
        x = torch.arange(3, dtype=torch.float32)
        first = g.run(fn, st, x)
        # the key's first call: a warm-up, a capture and a replay (which
        # the stand-in plays by calling again)
        assert len(calls) == 3 and len(fake_card) == 1
        assert CallGraph.warmups == 1 and g.mode == 'captured'
        assert torch.equal(first['twice'], x * 2)
        st['index'] = None                  # a replay sets no host value
        y = torch.tensor([5.0, 6.0, 7.0])
        second = g.run(fn, st, y)
        assert len(calls) == 4                      # the replay alone
        assert second is first and torch.equal(second['twice'], y * 2)
        assert st['sum'].item() == 18.0 and st['index'] is None
        (entry,) = g.entries.values()
        assert torch.equal(entry.inputs[0], y) and entry.replays == 2
        assert entry.delta == {'int8_matmul': 1}
        # warm-up and capture moved the wrapper's counter; the replays ran
        assert int8_matmul.launches == 2
        ran = StepGraph.device_launches(launch_counts())
        assert ran['int8_matmul'] == 3            # warm-up + 2 replays
        # a new shape, and the same shape on another state: new keys
        g.run(fn, st, torch.ones(4))
        assert len(fake_card) == 2 and len(g.entries) == 1
        other = {'sum': torch.zeros(())}
        g.run(fn, other, torch.ones(4))
        assert len(fake_card) == 3 and other['sum'].item() == 4.0
    finally:
        set_launch_counts(counts)
        StepGraph.reset_tally()


def test_call_graph_keeps_the_most_recent_keys(fake_card):
    calls, st = [], {'sum': torch.zeros(())}
    fn = _doubling(calls)
    counts = launch_counts()
    g = CallGraph(keep=2)
    try:
        for n in (1, 2, 1, 3, 1, 2):
            g.run(fn, st, torch.ones(n), key=('prefill',))
    finally:
        set_launch_counts(counts)
        StepGraph.reset_tally()
    # captured: 1, 2, 3 (dropping 2, the least recent), then 2 again
    assert len(fake_card) == 4
    assert [k[2][0][0] for k in g.entries] == [(1,), (2,)]


@pytest.mark.parametrize('name', sorted(launch_counts()))
def test_launch_counters_round_trip(name):
    """Every wrapper's counter, the flash backward's by mask included,
    reads and writes back by its name."""
    counts = launch_counts()
    assert {'flash_bwd.causal', 'flash_bwd.bidirectional'} <= set(counts)
    try:
        set_launch_counts({name: counts[name] + 7})
        now = launch_counts()
        assert now[name] == counts[name] + 7
        assert all(now[k] == v for k, v in counts.items() if k != name)
    finally:
        set_launch_counts(counts)


@pytest.mark.parametrize('mask', ['causal', 'bidirectional'])
def test_replays_count_the_flash_backward(fake_card, mask):
    """A captured call that launches the flash backward (a training
    step's) counts it a replay, by mask."""
    def fn(st, x):
        flash_bwd.launches[mask] += 1
        return {'y': x + 1}
    counts = launch_counts()
    StepGraph.reset_tally()
    set_launch_counts(dict.fromkeys(counts, 0))
    try:
        g = CallGraph()
        for _ in range(2):
            g.run(fn, None, torch.ones(2))
        (entry,) = g.entries.values()
        assert entry.delta == {f'flash_bwd.{mask}': 1}
        # the warm-up and two replays ran; the capture did not
        ran = StepGraph.device_launches(launch_counts())
        assert ran[f'flash_bwd.{mask}'] == 3
    finally:
        set_launch_counts(counts)
        StepGraph.reset_tally()


# ------------------------------------------------------------- the guard

@pytest.fixture
def guarded(monkeypatch):
    """Every CallGraph body runs under no_host_reads -> the bodies run."""
    bodies = []
    run = CallGraph.run

    def guarded_run(self, fn, state, *inputs, key=()):
        def checked(st, *args):
            with no_host_reads():
                out = fn(st, *args)
            bodies.append(fn.__name__)
            return out
        return run(self, checked, state, *inputs, key=key)
    monkeypatch.setattr(CallGraph, 'run', guarded_run)
    return bodies


def test_the_guard_catches_a_host_read():
    t = torch.ones(2)
    with no_host_reads():
        with pytest.raises(AssertionError, match='item'):
            t.sum().item()
        with pytest.raises(AssertionError, match='nonzero'):
            torch.nonzero(t)
        with pytest.raises(AssertionError, match='device'):
            torch.tensor(1.0, device=t.device)
        with pytest.raises(AssertionError, match='__setitem__'):
            t[0] = 3.0
        t[0] = t[1]                # a device value: allowed
    assert t.sum().item() == 2.0


@pytest.mark.parametrize('case', [
    'quant-int8-kv8', 'quant-int4', 'quant-w8a8-vision-int8-flash',
    'generator-scan', 'generator-loop-flash'])
def test_generator_prefills_read_nothing_back(guarded, monkeypatch, case):
    # small enough streams still take the flash and W8A8 routes
    monkeypatch.setattr(llama_quant, 'FLASH_MIN_SEQ', 8)
    monkeypatch.setattr(llama_quant, 'DENSE_MIN_ROWS', 8)
    monkeypatch.setattr('groma_tpu_torch.models.llama.FLASH_MIN_SEQ', 8)
    kw = dict(max_new_tokens=3, eos_id=-1)
    if case.startswith('generator'):
        tok, reqs = _prompts(CFG, 2, seed=4)
        gen = Generator(random_groma_unquantized(CFG, seed=0),
                        max_len=CFG.max_seq_len + 8,
                        use_flash=case.endswith('flash'))
        gen.generate(*_batch(reqs), use_scan=case == 'generator-scan', **kw)
        assert guarded == ['_prefill']
        return
    cfg = {'quant-int8-kv8': CFG, 'quant-int4': CFG4,
           'quant-w8a8-vision-int8-flash': CFG.replace(vision_int8=True)}[
        case]
    tok, reqs = _prompts(cfg, 2, seed=4)
    model, qp = random_groma(cfg, seed=0, bits=4 if case == 'quant-int4'
                             else 8)
    w8a8 = case.startswith('quant-w8a8')
    gen = QuantGenerator(model, qp, max_len=cfg.max_seq_len + 8, kv_bits=8,
                         use_flash=w8a8, w8a8_prefill=w8a8)
    routes = []
    if w8a8:
        assert model.region_encoder.quant
        for module, name in ((llama_quant, 'w8a8_matmul'),
                             (region_encoder, 'w8a8_conv')):
            def counted(*a, _fn=getattr(module, name), _name=name):
                routes.append(_name)
                return _fn(*a)
            monkeypatch.setattr(module, name, counted)
    gen.generate(*_batch(reqs), **kw)
    assert guarded == ['_prefill']
    if w8a8:
        assert set(routes) == {'w8a8_matmul', 'w8a8_conv'}


@pytest.mark.parametrize('case', ['int8-b1', 'int8-b2', 'unquantized-b1',
                                  'unquantized-b2', 'chunked'])
def test_engine_prefills_read_nothing_back(guarded, case):
    tok, reqs = _prompts(CFG, 2, seed=5)
    if case.startswith('unquantized'):
        model, qp = random_groma_unquantized(CFG, seed=0), None
    else:
        model, qp = random_groma(CFG, seed=0)
    engine = BatchEngine(model, qp, max_slots=2,
                         max_len=CFG.max_seq_len + 16, eos_id=-1, chunk=2,
                         max_new_tokens=4, kv_bits=16 if qp is None else 8,
                         admit_batch=2,
                         prefill_chunk_tokens=48 if case == 'chunked'
                         else None)
    rows = [(None, *r) for r in reqs]
    try:
        with torch.inference_mode():
            if case == 'chunked':
                engine._chunked_prefill(rows[0])
            else:
                engine._prefill(rows[:2] if case.endswith('b2')
                                else rows[:1])
    finally:
        engine.close()
    assert guarded == (['_prepare_one', '_last_logits'] if case == 'chunked'
                       else ['_prefill_one'])


# ---------------------------------------- against JAX, the second a replay


def _index_at_begin(monkeypatch):
    """DecodeScan.begin records the cache's index it starts from."""
    seen = []
    begin = DecodeScan.begin

    def recording(self, logits, next_pos):
        seen.append(self.kv['index'])
        return begin(self, logits, next_pos)
    monkeypatch.setattr(DecodeScan, 'begin', recording)
    return seen


@pytest.mark.parametrize('use_scan', [True, False])
def test_generator_prefill_graph_matches_jax(params, fake_card, monkeypatch,
                                             use_scan):
    jmodel, p = params
    tok, reqs = _prompts(CFG, 3, seed=7)
    max_len = CFG.max_seq_len + MAX_NEW
    kw = dict(max_new_tokens=MAX_NEW, eos_id=tok.sp.eos)
    jgen = JGenerator(jmodel, p, max_len=max_len)
    gen = Generator(from_jax_params(p, CFG), max_len=max_len)
    seen = _index_at_begin(monkeypatch)
    for rows in (reqs[:2], reqs[1:]):              # one key, twice
        args = _batch(rows)
        want, j_vis = jgen.generate(*map(jnp.asarray, args),
                                    use_scan=use_scan, **kw)
        j_logits = jgen._prefill(jgen.params, *map(jnp.asarray, args),
                                 jnp.zeros((2, 0, 4)),
                                 jnp.zeros((2, 0), bool))[0]
        got, vis = gen.generate(*args, use_scan=use_scan, **kw)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(vis['selected_mask'],
                                      j_vis['selected_mask'])
        np.testing.assert_allclose(vis['selected_boxes'],
                                   j_vis['selected_boxes'], atol=BOX_TOL)
        np.testing.assert_allclose(gen.last_stats['first_logits'],
                                   np.asarray(j_logits), atol=F32_TOL,
                                   rtol=0)
        assert gen.last_stats['prefill_mode'] == 'captured'
    assert len(fake_card) == 1
    ((entry),) = gen._prefills.entries.values()
    assert entry.replays == 2
    assert seen == ([CFG.max_seq_len] * 2 if use_scan else [])


@pytest.mark.parametrize('bits', [8, 4])
def test_quant_generator_prefill_graph_matches_jax(params4, fake_card,
                                                   monkeypatch, bits):
    jmodel, p = params4
    tok, reqs = _prompts(CFG4, 2, seed=8)
    max_len = CFG4.max_seq_len + MAX_NEW
    kw = dict(max_new_tokens=MAX_NEW, eos_id=tok.sp.eos)
    jgen = JQuantGenerator(jmodel, p, j_quantize(p, CFG4, bits=bits),
                           max_len=max_len, kv_bits=8)
    tmodel = from_jax_params(p, CFG4)
    gen = QuantGenerator(tmodel, quantize_groma_llm(tmodel, CFG4, bits=bits),
                         max_len=max_len, kv_bits=8)
    seen = _index_at_begin(monkeypatch)
    for req in reqs:                               # one key, twice
        args = _batch([req])
        want, j_vis = jgen.generate(*map(jnp.asarray, args), **kw)
        j_logits = jgen._prefill(jgen.params, jgen.qp,
                                 *map(jnp.asarray, args),
                                 jnp.zeros((1, 0, 4)),
                                 jnp.zeros((1, 0), bool))[0]
        got, vis = gen.generate(*args, **kw)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(vis['selected_mask'],
                                      j_vis['selected_mask'])
        np.testing.assert_allclose(vis['selected_boxes'],
                                   j_vis['selected_boxes'], atol=BOX_TOL)
        np.testing.assert_allclose(gen.last_stats['first_logits'],
                                   np.asarray(j_logits), atol=QUANT_TOL,
                                   rtol=QUANT_TOL)
        assert gen.last_stats['prefill_mode'] == 'captured'
    assert len(fake_card) == 1 and seen == [CFG4.max_seq_len] * 2


def _seat_recorder(engine, firsts, indices=None):
    seat = engine._seat

    def recording(slot, sess, row_logits, one, *a, **kw):
        # a copy: the port's logits belong to the prefill's graph
        firsts[id(sess)] = np.array(row_logits.float() if torch.is_tensor(
            row_logits) else row_logits, np.float32)
        if indices is not None:
            indices.append(one['index'])
        return seat(slot, sess, row_logits, one, *a, **kw)
    engine._seat = recording


@pytest.mark.parametrize('mode', ['int8', 'unquantized', 'int8-batched',
                                  'chunked'])
def test_engine_prefill_graph_matches_jax(params4, fake_card, mode):
    """Three requests through 2 slots: JAX's engine and the port's, whose
    prefill programs capture once a key and replay after (with
    admit_batch=2, a b=2 key and a b=1 one)."""
    jmodel, p = params4
    tok, reqs = _prompts(CFG4, 3, seed=9)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW,
              kv_bits=16 if mode == 'unquantized' else 8,
              admit_batch=2 if mode == 'int8-batched' else 1,
              prefill_chunk_tokens=48 if mode == 'chunked' else None)
    jqp = None if mode == 'unquantized' else j_quantize(p, CFG4, bits=8)
    tmodel = from_jax_params(p, CFG4)
    tqp = None if mode == 'unquantized' else quantize_groma_llm(tmodel, CFG4)
    outs, firsts, vis = [], [], []
    indices = []
    for engine in (JEngine(jmodel, p, qp=jqp, **kw),
                   BatchEngine(tmodel, tqp, **kw)):
        first = {}
        _seat_recorder(engine, first, indices if isinstance(
            engine, BatchEngine) else None)
        try:
            sessions = [engine.submit(*r) for r in reqs]
            outs.append([list(s.token_stream()) for s in sessions])
            firsts.append([first[id(s)] for s in sessions])
            vis.append([s.vis for s in sessions])
            if isinstance(engine, BatchEngine):
                assert engine.stats()['prefill_mode'] == 'captured'
        finally:
            engine.close()
    assert outs[1] == outs[0]
    for got, want in zip(firsts[1], firsts[0]):
        tol = F32_TOL if mode == 'unquantized' else ENGINE_REL_TOL[
            'chunked' if mode == 'chunked' else 'one-shot'] \
            * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    for got, want in zip(vis[1], vis[0]):
        np.testing.assert_array_equal(got['selected_mask'],
                                      np.asarray(want['selected_mask']))
        np.testing.assert_allclose(got['selected_boxes'],
                                   np.asarray(want['selected_boxes']),
                                   atol=BOX_TOL)
    if mode == 'chunked':
        # prepare_one and last_logits, each captured once
        assert len(fake_card) == 2
        assert all(0 < i <= CFG4.max_seq_len for i in indices)
    else:
        assert len(fake_card) == (2 if mode == 'int8-batched' else 1)
        assert indices == [CFG4.max_seq_len] * 3
