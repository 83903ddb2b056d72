"""The engine's speculative mode (``spec_lookahead``) against the JAX
``BatchEngine``'s.

* The verify step (``BatchEngine.verifier``) against JAX's jitted
  ``_verify_chunk`` on identical state, over an int8 and a float cache:
  six slots, G = 4 -- every draft right, a draft wrong mid-run, an EOS
  inside the accepted run, a finished row, an idle row and a row at the
  enlarged cap (its last write at the cache's last slot).  ``emitted``,
  ``counts``, the next tokens, positions and done flags, the rewound mask
  and indices equal; the written keys and values close (int8 codes
  equal).  A row one slot further is refused before any write.
* Speculative mode as JAX has it: ``max_len`` grown by G, the loop's
  streams those of the sequential engine (and of JAX's speculative
  engine), ``ValueError`` for a sampled request, ``paged_kv`` and
  ``qp=None``.
* The verify step and the chunk step read nothing back and send no host
  data to a device (the guard of ``test_torch_graphs.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
from groma_tpu_torch.serve.engine import BatchEngine
from tests.test_torch_engine import CFG, _requests, _serve
from tests.test_torch_graphs import guarded  # noqa: F401 (a fixture)

torch.set_num_threads(2)
G = 4
SLOTS = 6
MAX_LEN = 100             # 128 slots, 256 with the lookahead
LLM = CFG.llm


@pytest.fixture(scope='module')
def models():
    jmodel = JGroma(CFG)
    p = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                    **_dummy_batch(CFG)))()['params']
    p = jax.tree_util.tree_map(np.asarray, p)
    tmodel = from_jax_params(p, CFG)
    trees = {bits: (j_quantize(p, CFG, bits=bits),
                    quantize_groma_llm(tmodel, CFG, bits=bits))
             for bits in (16, 8)}
    return jmodel, p, tmodel, trees


def _state(kind, length, index, seed=0):
    """A decode state of SLOTS rows as numpy arrays: a random cache (int8
    codes and scales, or floats), each row's mask True on a random subset
    of its slots below its index (slot 0 always), and per-row tokens,
    positions, active and done flags."""
    rng = np.random.default_rng(seed)
    hd = LLM.hidden_size // LLM.num_heads
    shape = (SLOTS, LLM.num_kv_heads, length, hd)
    cache = {}
    for key in ('k', 'v'):
        cache[key] = [rng.integers(-127, 128, shape).astype(np.int8)
                      if kind == 'int8' else
                      rng.standard_normal(shape).astype(np.float32)
                      for _ in range(LLM.num_layers)]
    if kind == 'int8':
        for key in ('k_scale', 'v_scale'):
            cache[key] = [rng.uniform(0.005, 0.02, shape[:-1]).astype(
                np.float32) for _ in range(LLM.num_layers)]
    slots = np.arange(length)[None]
    mask = (rng.random((SLOTS, length)) < 0.8) & (slots < index[:, None])
    mask[:, 0] = True
    cache['mask'] = mask
    cache['index'] = index
    return {'cache': cache,
            'tok': rng.integers(3, LLM.vocab_size, SLOTS),
            'pos': index - 3,
            'active': np.asarray([1, 1, 1, 1, 0, 1], bool),
            'done': np.asarray([0, 0, 0, 1, 1, 0], bool)}


def _port(state):
    cache = {k: [torch.from_numpy(t.copy()) for t in v]
             if isinstance(v, list) else torch.from_numpy(v.copy())
             for k, v in state['cache'].items()}
    cache['index'] = cache['index'].long()
    out = {k: torch.from_numpy(np.array(state[k]))
           for k in ('tok', 'pos', 'active', 'done')}
    out['tok'], out['pos'] = out['tok'].long(), out['pos'].long()
    out['cache'] = cache
    return out


def _greedy_drafts(engine, state):
    """Each live row's G greedy drafts, teacher-forced one verify at a
    time on copies of the state (no EOS), and the bonus token after them."""
    eos, engine.eos_id = engine.eos_id, -5
    drafts = np.zeros((SLOTS, G), np.int64)
    try:
        for _ in range(G + 1):
            emitted, counts = engine.verifier(_port(state))(drafts)
            for r in range(SLOTS):
                if counts[r] and counts[r] <= G:
                    drafts[r, counts[r] - 1] = emitted[r, counts[r] - 1]
    finally:
        engine.eos_id = eos
    return drafts, emitted[:, G]


@pytest.mark.parametrize('kind', ['int8', 'float'])
def test_verify_step_matches_jax(models, kind):
    jmodel, params, tmodel, trees = models
    jqp, tqp = trees[16]
    kv_bits = 8 if kind == 'int8' else 16
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, kv_bits=kv_bits,
              spec_lookahead=G)
    engine = BatchEngine(tmodel, tqp, eos_id=-5, **kw)
    engine.close()
    length = engine.max_len
    assert length == 256
    index = np.asarray([40, 55, 70, 30, 20, length - G - 1])
    state = _state(kind, length, index)
    state['tok'][3:5] = 7                 # rows not live carry EOS
    drafts, bonus = _greedy_drafts(engine, state)
    runs = [list(drafts[r]) + [bonus[r]] for r in range(SLOTS)]
    # an EOS id that row 2 emits second and rows 0 and 5 never emit
    eos = int(drafts[2, 1])
    assert eos not in runs[2][:1] + runs[0] + runs[5], runs
    state['tok'][3:5] = eos
    drafts[1, 2] = (drafts[1, 2] + 1) % LLM.vocab_size   # wrong mid-run
    drafts[3:5] = [3, 4, 5, 6]
    engine.eos_id = eos
    st = _port(state)
    emitted, counts = engine.verifier(st)(drafts)

    jeng = JEngine(jmodel, params, qp=jqp, eos_id=eos, **kw)
    jeng.close()
    assert jeng.max_len == length
    jcache = jax.tree_util.tree_map(jnp.asarray, state['cache'])
    jcache['index'] = jnp.asarray(index, jnp.int32)
    jc, jemitted, jcounts, jtok, jpos, jdone = jeng._verify_chunk(
        jqp, jcache, jnp.asarray(state['tok'], jnp.int32),
        jnp.asarray(drafts, jnp.int32), jnp.asarray(state['pos'], jnp.int32),
        jnp.asarray(state['active']), jnp.asarray(state['done']))
    np.testing.assert_array_equal(emitted, np.asarray(jemitted))
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(st['tok'].numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(st['pos'].numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(st['done'].numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(st['cache']['mask'].numpy(),
                                  np.asarray(jc['mask']))
    np.testing.assert_array_equal(st['cache']['index'].numpy(),
                                  np.asarray(jc['index']))
    for key in ('k', 'v', 'k_scale', 'v_scale') if kind == 'int8' \
            else ('k', 'v'):
        for got, want in zip(st['cache'][key], jc[key]):
            if kind == 'int8' and key in ('k', 'v'):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5)
    # the cases: all right, wrong at the third draft, EOS second, frozen,
    # idle, all right at the cap
    assert list(counts) == [G + 1, 3, 2, 0, 0, G + 1]
    # the index keeps the whole accepted run, the EOS row's too (as JAX's)
    kept = np.asarray([G + 1, 3, G + 1, 0, 0, G + 1])
    np.testing.assert_array_equal(st['cache']['index'].numpy(), index + kept)
    assert (emitted[3:5] == eos).all()
    for r in (3, 4):
        assert int(st['tok'][r]) == eos and bool(st['done'][r])
        assert int(st['pos'][r]) == state['pos'][r]
    mask = st['cache']['mask'].numpy()
    keep = index + kept
    for r in range(SLOTS):
        assert not mask[r, keep[r]:index[r] + G + 1].any()
        np.testing.assert_array_equal(mask[r, :index[r]],
                                      state['cache']['mask'][r, :index[r]])
    # one slot further the row's last write would leave the cache
    state['cache']['index'] = index + np.asarray([0, 0, 0, 0, 0, 1])
    before = _port(state)
    with pytest.raises(ValueError, match='would write up to slot 256'):
        engine.verifier(before)(drafts)
    np.testing.assert_array_equal(before['cache']['mask'].numpy(),
                                  state['cache']['mask'])


def test_speculative_engine_streams_are_the_sequential_ones(models):
    """JAX's test_engine_speculative_matches_sequential on the port: the
    loop decodes sequentially (as JAX's), so the speculative engine's
    streams are the sequential engine's and JAX's speculative engine's,
    with a request that waits for a slot; the context each session keeps
    is its prompt and its stream."""
    jmodel, params, tmodel, trees = models
    jqp, tqp = trees[16]
    tok, reqs = _requests(CFG, 3)
    kw = dict(max_slots=2, max_len=CFG.max_seq_len + 7 + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=7)
    want, _ = _serve(BatchEngine(tmodel, tqp, **kw), reqs)
    engine = BatchEngine(tmodel, tqp, spec_lookahead=3, **kw)
    assert engine.max_len == 384                # 256 + 3, rounded up
    got, sessions = _serve(engine, reqs)
    j_spec, _ = _serve(JEngine(jmodel, params, qp=jqp, spec_lookahead=3,
                               **kw), reqs)
    assert got == want == j_spec
    for sess, (_, ids, _, valid), stream in zip(sessions, reqs, got):
        assert sess._ctx == [int(t) for t, v in zip(ids, valid) if v] \
            + stream


def test_speculative_engine_refuses_what_jax_refuses(models):
    _, _, tmodel, trees = models
    tqp = trees[8][1]
    tok, reqs = _requests(CFG, 1)
    engine = BatchEngine(tmodel, tqp, max_slots=1, spec_lookahead=2,
                         max_len=CFG.max_seq_len + 16, eos_id=tok.sp.eos)
    try:
        with pytest.raises(ValueError, match='greedily'):
            engine.submit(*reqs[0], temperature=0.7)
    finally:
        engine.close()
    for kw in ({'spec_lookahead': 2}, {'prefill_chunk_tokens': 16}):
        with pytest.raises(ValueError, match='excludes'):
            BatchEngine(tmodel, tqp, paged_kv=True, kv_bits=8, **kw)
    with pytest.raises(ValueError, match='qp'):
        BatchEngine(tmodel, None, spec_lookahead=2)
    engine = BatchEngine(tmodel, tqp, max_slots=1)
    engine.close()
    with pytest.raises(ValueError, match='spec_lookahead'):
        engine.verifier(engine.clone_state())


def test_verify_and_chunk_steps_read_nothing_back(models, guarded):
    """Both steps as the card captures them: no host read, no host data
    sent to a device, inside the step."""
    _, _, tmodel, trees = models
    tok, reqs = _requests(CFG, 2)
    engine = BatchEngine(tmodel, trees[8][1], max_slots=2, chunk=2,
                         max_len=CFG.max_seq_len + 16, eos_id=tok.sp.eos,
                         max_new_tokens=4, kv_bits=8, prefill_chunk_tokens=9,
                         spec_lookahead=2)
    try:
        got = [list(s.token_stream())
               for s in [engine.submit(*r) for r in reqs]]
    finally:
        engine.close()
    assert all(len(g) == 4 for g in got)
    n_chunks = sum(int(np.nonzero(r[3])[0][-1]) // 9 + 1 for r in reqs)
    assert len(guarded) >= n_chunks + 1        # the chunks and a burst
    before = len(guarded)
    emitted, counts = engine.verifier(engine.clone_state())(
        np.zeros((2, 2), np.int64))
    assert len(guarded) == before + 1 and emitted.shape == (2, 3)
