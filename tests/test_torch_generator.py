"""The unquantized path of the port against the JAX package on the same
weights (``from_jax_params``) and inputs, at the tiny configs on the CPU:
the cached LLaMA forward in its three modes (MHA and GQA), the model's
``prefill`` / ``decode_step``, the ``Generator`` (both decode loops),
``BatchEngine(qp=None)``, and the REC harness; then the port's own entry
points on this path (worker, ``run_groma``, the CLI, ``eval_rec``).

Tolerances: f32 hidden states, caches and logits within 2e-5 absolute
(values of order 1; the two packages sum in other orders); greedy tokens
and ``selected_mask`` exactly; ``selected_boxes`` within 1e-5 (f32 through
the vision tower); the bf16 LLM's logits within 3e-2 x max|logits| (bf16
activations rounded at other points).  ``box_score_thres=0.0`` lets NMS
keep several boxes.
"""

import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate import Generator as JGenerator
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.eval.rec import evaluate_rec as j_evaluate_rec
from groma_tpu.eval.region_cap import build_region_cap_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama import LlamaModel as JLlama
from groma_tpu.models.llama import make_kv_cache as j_make_cache
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.hf_export import export_groma
from groma_tpu_torch.checkpoint.loader import (from_jax_params,
                                               from_state_dict,
                                               random_groma_unquantized)
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.generate import Generator
from groma_tpu_torch.eval.rec import RECMetrics, evaluate_rec
from groma_tpu_torch.models.llama import LlamaModel, make_kv_cache
from groma_tpu_torch.serve.engine import BatchEngine

torch.set_num_threads(2)

CFG = tiny_groma_config(box_score_thres=0.0)
SPEC = VLDataSpec(num_image_tokens=CFG.num_image_tokens,
                  max_region_num=CFG.max_region_num,
                  max_seq_len=CFG.max_seq_len,
                  image_size=CFG.perceiver.image_size)
TOK = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
F32_TOL = 2e-5
MAX_NEW = 8
MAX_LEN = CFG.max_seq_len + MAX_NEW


@pytest.fixture(scope='module')
def params():
    model = JGroma(CFG)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG)))()['params']
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope='module')
def tmodel(params):
    return from_jax_params(params, CFG)


def _images(b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 56, 56, 3)).astype(np.float32)


def _batch(b, refer: bool):
    """(images, input_ids, region_slot, valid) of b prompts, each its own,
    and the refer boxes when asked: the REC template (pad gaps in the
    region block), or the region-captioning one with one user box."""
    if refer:
        ts = [build_region_cap_prompt(TOK, SPEC) for _ in range(b)]
    else:
        ts = [build_rec_prompt(f'the dog {i}', TOK, SPEC) for i in range(b)]
    args = (_images(b), *(np.stack([t[k] for t in ts])
                          for k in ('input_ids', 'region_slot', 'valid')))
    kw = {}
    if refer:
        boxes = np.asarray([[0.4, 0.5, 0.3, 0.4], [0.6, 0.3, 0.2, 0.2]],
                           np.float32)[:b, None]
        kw = dict(refer_boxes=boxes, refer_valid=np.ones((b, 1), bool))
    return args, kw


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _jax_prefill_decode(cfg):
    """JAX GromaModel.prefill and decode_step, compiled."""
    m = JGroma(cfg)
    prefill = jax.jit(lambda p, *a: m.apply({'params': p}, *a,
                                            max_len=MAX_LEN,
                                            method=JGroma.prefill))
    decode = jax.jit(lambda p, *a: m.apply({'params': p}, *a,
                                           method=JGroma.decode_step))
    return prefill, decode


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


# ------------------------------------------------ the cached LLaMA forward

def _llama_from_jax(p, cfg):
    """The port's LlamaModel on the JAX LlamaModel's params."""
    model = LlamaModel(cfg)
    sd = {'norm.weight': p['norm']['scale'],
          'embed_tokens.weight': np.zeros(
              (cfg.vocab_size, cfg.hidden_size), np.float32)}
    for i in range(cfg.num_layers):
        lp, pre = p[f'layers_{i}'], f'layers.{i}.'
        for n in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            sd[f'{pre}self_attn.{n}.weight'] = lp['self_attn'][n]['kernel'].T
        for n in ('gate_proj', 'up_proj', 'down_proj'):
            sd[f'{pre}mlp.{n}.weight'] = lp[n]['kernel'].T
        for n in ('input_layernorm', 'post_attention_layernorm'):
            sd[f'{pre}{n}.weight'] = lp[n]['scale']
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.eval()


@pytest.mark.parametrize('num_kv_heads', [4, 2])
def test_cached_llama_forward_matches_jax(num_kv_heads):
    """Prefill of a padded stream, two scalar-index decode steps, then two
    vector-index steps at ragged per-row indices: the hidden states after
    every call and the whole cache at the end."""
    cfg = CFG.llm.replace(num_kv_heads=num_kv_heads)
    b, s, max_len, d = 2, 10, 20, cfg.hidden_size
    rng = np.random.default_rng(1)
    valid = np.ones((b, s), bool)
    valid[0, 3:5] = False                      # a pad gap mid-stream
    valid[1, 8:] = False                       # a padded tail
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0)
    calls = [(rng.standard_normal((b, s, d)).astype(np.float32), valid, pos)]
    nxt = pos.max(-1, keepdims=True) + 1
    for i in range(2):
        calls.append((rng.standard_normal((b, 1, d)).astype(np.float32),
                      np.ones((b, 1), bool), nxt + i))
    index = np.asarray([s + 2, s + 4])         # row 1 skips two slots
    for i in range(2):
        calls.append((rng.standard_normal((b, 1, d)).astype(np.float32),
                      np.ones((b, 1), bool), nxt + 2 + i))

    jmodel = JLlama(cfg)
    p = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(calls[0][0]),
        jnp.asarray(valid), jnp.asarray(pos))['params'])
    jcache = j_make_cache(cfg, b, max_len, dtype=jnp.float32)
    tmodel = _llama_from_jax(p, cfg)
    tcache = make_kv_cache(cfg, b, max_len)
    with torch.no_grad():
        for n, (x, m, ps) in enumerate(calls):
            if n == 3:
                jcache = {**jcache, 'index': jnp.asarray(index, jnp.int32)}
                tcache['index'] = torch.as_tensor(index)
            jh, jcache = jmodel.apply({'params': p}, jnp.asarray(x),
                                      jnp.asarray(m), jnp.asarray(ps), jcache)
            th, tcache = tmodel(torch.from_numpy(x), torch.from_numpy(m),
                                torch.from_numpy(ps), tcache)
            _close(th, jh)
    for key in ('k', 'v'):
        for t_l, j_l in zip(tcache[key], jcache[key]):
            assert t_l.shape[1] == num_kv_heads
            _close(t_l, j_l)
    np.testing.assert_array_equal(tcache['mask'].numpy(), jcache['mask'])
    np.testing.assert_array_equal(tcache['index'].numpy(), jcache['index'])


def test_cache_write_past_the_end_raises():
    cfg = CFG.llm
    model = LlamaModel(cfg)
    cache = make_kv_cache(cfg, 1, 4)
    cache['index'] = 4
    with torch.no_grad(), pytest.raises(ValueError, match='overflow'):
        model(torch.zeros(1, 1, cfg.hidden_size), torch.ones(1, 1, dtype=bool),
              torch.zeros(1, 1, dtype=torch.int64), cache)


# --------------------------------------------------- prefill, decode_step

@pytest.mark.parametrize('box_score_thres', [0.0, 0.15])
def test_prefill_and_decode_step_match_jax(params, box_score_thres):
    """On the padded REC template: logits, the cache (its index counts
    every slot, the next position only the valid tokens) and two decode
    steps.  At the default 0.15 random weights keep one region of 8, so
    the unused region slots leave pad gaps mid-stream; at 0.0 the stream
    has only its padded tail."""
    cfg = CFG.replace(box_score_thres=box_score_thres)
    tmodel = from_jax_params(params, cfg)
    (images, ids, rslot, valid), _ = _batch(2, refer=False)
    prefill, decode = _jax_prefill_decode(cfg)
    j_logits, jc, _, j_next = prefill(
        params, *map(jnp.asarray, (images, ids, rslot, valid)))
    gaps = box_score_thres > 0
    assert (j_next[:, 0] < valid.sum(-1)).all() == gaps
    with torch.no_grad():
        t_logits, tc, _, t_next = tmodel.prefill(
            *map(torch.as_tensor, (images, ids, rslot, valid)),
            max_len=MAX_LEN)
    assert t_logits.dtype == torch.float32
    _close(t_logits, j_logits)
    np.testing.assert_array_equal(t_next.numpy(), j_next)
    assert tc['index'] == int(jc['index']) == CFG.max_seq_len
    assert (t_next[:, 0] < CFG.max_seq_len).all()    # two counters differ
    np.testing.assert_array_equal(tc['mask'].numpy(), jc['mask'])
    for t_l, j_l in zip(tc['k'] + tc['v'], jc['k'] + jc['v']):
        _close(t_l, j_l)
    tok = np.asarray([[5], [300]])                   # a base and a new id
    for i in range(2):
        j_logits, jc = decode(params, jnp.asarray(tok), jc, j_next + i)
        with torch.no_grad():
            t_logits, tc = tmodel.decode_step(torch.as_tensor(tok), tc,
                                              t_next + i)
        _close(t_logits, j_logits)
    for t_l, j_l in zip(tc['k'] + tc['v'], jc['k'] + jc['v']):
        _close(t_l, j_l)
    np.testing.assert_array_equal(tc['mask'].numpy(), jc['mask'])


def test_bf16_llm_matches_jax_and_the_cast_at_use(params):
    """The LLM in bf16: the trunk stored in bf16 gives bit for bit the
    products of f32 weights cast at use, and the logits agree with JAX's
    within 3e-2 x max|logits|."""
    cfg = CFG.replace(llm=CFG.llm.replace(dtype='bfloat16'))
    (images, ids, rslot, valid), _ = _batch(1, refer=False)
    prefill, decode = _jax_prefill_decode(cfg)
    want, jc, _, j_next = prefill(
        params, *map(jnp.asarray, (images, ids, rslot, valid)))
    want_step, _ = decode(params, jnp.asarray([[7]]), jc, j_next)
    got = {}
    for name, dtype in (('stored', torch.bfloat16), ('cast', None)):
        m = from_state_dict(export_groma(params, cfg), cfg,
                            llm_linear_dtype=dtype)
        assert m.llm.model.layers[0].mlp.up_proj.weight.dtype == (
            dtype or torch.float32)
        assert m.llm.lm_head.weight.dtype == torch.float32
        with torch.no_grad():
            lg, tc, _, nxt = m.prefill(
                *map(torch.as_tensor, (images, ids, rslot, valid)),
                max_len=MAX_LEN)
            assert tc['k'][0].dtype == torch.bfloat16
            step, _ = m.decode_step(torch.as_tensor([[7]]), tc, nxt)
        got[name] = (lg, step)
    for a, b in zip(got['stored'], got['cast']):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for g, w in zip(got['stored'], (want, want_step)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 3e-2, err


# -------------------------------------------------------------- Generator

@pytest.fixture(scope='module')
def jgen(params):
    return JGenerator(JGroma(CFG), params, max_len=MAX_LEN)


@pytest.mark.parametrize('b,refer,box_score_thres', [
    (1, False, 0.0), (2, False, 0.0), (1, True, 0.0), (2, True, 0.0),
    (2, False, 0.15)])
def test_generator_matches_jax(params, jgen, tmodel, b, refer,
                               box_score_thres):
    """Greedy tokens exactly and the same boxes, in both decode loops; at
    0.15 one region is kept and the stream has pad gaps mid-way."""
    args, kw = _batch(b, refer)
    kw = dict(kw, max_new_tokens=MAX_NEW, eos_id=TOK.sp.eos)
    if box_score_thres:
        cfg = CFG.replace(box_score_thres=box_score_thres)
        jgen = JGenerator(JGroma(cfg), params, max_len=MAX_LEN)
        tmodel = from_jax_params(params, cfg)
    gen = Generator(tmodel, max_len=MAX_LEN)
    for use_scan in (True, False):
        want, j_vis = jgen.generate(*map(_j, args), use_scan=use_scan,
                                    **{k: _j(v) for k, v in kw.items()})
        got, t_vis = gen.generate(*args, use_scan=use_scan, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_vis['selected_mask'],
                                      j_vis['selected_mask'])
        _close(t_vis['selected_boxes'], j_vis['selected_boxes'], 1e-5)
        kept = t_vis['selected_mask'].sum(-1)
        assert (kept == 1).all() if box_score_thres else (kept > 1).all()
    assert gen.last_stats['logits_finite']


def test_generator_eos_reached_by_one_row_only(jgen, tmodel):
    """An EOS id that one row emits mid-way and the other never does: with
    use_scan that row is cut after it and padded with EOS, and without it
    the rows are not forced to EOS and the loop runs on for the other.
    The two prompts differ in more than a number: on the tiny random model
    'the dog 0' and 'the dog 1' decode the same two-token cycle, which
    leaves no id to one row alone."""
    ts = [build_rec_prompt(text, TOK, SPEC)
          for text in ('the dog on the left', 'the cat on the right')]
    args = (_images(2), *(np.stack([t[k] for t in ts])
                          for k in ('input_ids', 'region_slot', 'valid')))
    gen = Generator(tmodel, max_len=MAX_LEN)
    free, _ = gen.generate(*args, max_new_tokens=MAX_NEW, eos_id=-1)
    rows = [[int(t) for t in r] for r in free]
    # the first id a row emits at a step 1 .. MAX_NEW - 2 that it did not
    # emit before and the other row never emits: whatever the prompts
    pick = next(((r, j, t) for r in (0, 1) for j, t in enumerate(rows[r])
                 if 0 < j < MAX_NEW - 1 and t not in rows[r][:j]
                 and t not in rows[1 - r]), None)
    assert pick is not None, f'no id is emitted by one row only: {rows}'
    r, stop, eos = pick
    for use_scan in (True, False):
        want, _ = jgen.generate(*map(jnp.asarray, args),
                                max_new_tokens=MAX_NEW, eos_id=eos,
                                use_scan=use_scan)
        got, _ = gen.generate(*args, max_new_tokens=MAX_NEW, eos_id=eos,
                              use_scan=use_scan)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (2, MAX_NEW)
        assert got[r, stop] == eos and eos not in got[1 - r]
        if use_scan:
            assert (got[r, stop:] == eos).all()
    assert gen.last_stats['decode_forwards'] == MAX_NEW - 1


def test_generator_sampling(tmodel):
    """The same torch.Generator seed gives the same tokens, another seed
    others; T -> 0 gives the greedy tokens; every token is in the
    vocabulary."""
    args, _ = _batch(2, refer=False)
    gen = Generator(tmodel, max_len=MAX_LEN)
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1)
    greedy, _ = gen.generate(*args, **kw)

    def sampled(seed, temperature=1.0, use_scan=True):
        g = torch.Generator().manual_seed(seed)
        return gen.generate(*args, temperature=temperature, generator=g,
                            use_scan=use_scan, **kw)[0]
    a = sampled(3)
    np.testing.assert_array_equal(a, sampled(3))
    np.testing.assert_array_equal(a, sampled(3, use_scan=False))
    assert not np.array_equal(a, sampled(4))
    assert not np.array_equal(a, greedy)
    np.testing.assert_array_equal(sampled(5, temperature=1e-7), greedy)
    vocab = CFG.llm.vocab_size + CFG.num_new_token
    assert ((a >= 0) & (a < vocab)).all()


def test_generator_refuses_a_decode_longer_than_the_cache(tmodel):
    args, _ = _batch(1, refer=False)
    with pytest.raises(ValueError, match='does not fit the KV cache'):
        Generator(tmodel, max_len=MAX_LEN).generate(
            *args, max_new_tokens=MAX_NEW + 2)


# ----------------------------------------------------------------- engine

def _requests(n):
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(n):
        t = build_rec_prompt(f'thing {i}', TOK, SPEC)
        reqs.append((rng.standard_normal((56, 56, 3)).astype(np.float32),
                     t['input_ids'], t['region_slot'], t['valid']))
    return reqs


def _serve(engine, reqs):
    """Two requests, then a third once they are decoding (2 slots: it
    waits for a free one)."""
    try:
        sessions = [engine.submit(*r) for r in reqs[:2]]
        while not all(s.tokens for s in sessions):
            time.sleep(0.01)
        sessions.append(engine.submit(*reqs[2]))
        return [list(s.token_stream()) for s in sessions], sessions
    finally:
        engine.close()


def test_unquantized_engine_matches_jax_engine_and_generator(params,
                                                             tmodel):
    reqs = _requests(3)
    kw = dict(max_slots=2, max_len=CFG.max_seq_len + MAX_NEW + 8,
              eos_id=TOK.sp.eos, chunk=2, max_new_tokens=MAX_NEW)
    want, _ = _serve(JEngine(JGroma(CFG), params, **kw), reqs)
    engine = BatchEngine(tmodel, None, **kw)
    got, sessions = _serve(engine, reqs)
    assert got == want
    assert all(len(g) >= 2 for g in got)       # decode ran, not just prefill
    assert engine.stats()['finished'] == 3
    gen = Generator(tmodel, max_len=kw['max_len'])
    for stream, sess, (img, ids, rslot, valid) in zip(got, sessions, reqs):
        toks, vis = gen.generate(img[None], ids[None], rslot[None],
                                 valid[None], max_new_tokens=MAX_NEW,
                                 eos_id=TOK.sp.eos)
        assert stream == [int(t) for t in toks[0]][:len(stream)]
        _close(sess.vis['selected_boxes'], vis['selected_boxes'][0], 1e-5)


def test_unquantized_engine_refuses_what_jax_refuses(tmodel):
    for kw in ({'kv_bits': 8}, {'kv_bits': 8, 'paged_kv': True}):
        with pytest.raises(ValueError, match='qp=None'):
            BatchEngine(tmodel, None, **kw)
    for kw, match in (({'prefill_chunk_tokens': 16}, 'chunked prefill'),
                      ({'spec_lookahead': 2}, 'speculative')):
        with pytest.raises(ValueError, match=match):
            BatchEngine(tmodel, None, **kw)


# -------------------------------------------------------------- REC kit

@pytest.mark.parametrize('batch_size', [1, 3])
def test_evaluate_rec_matches_jax(jgen, tmodel, batch_size):
    """Four synthetic samples (a ragged last batch at 3); each ground
    truth is one of the pool's boxes, so a named region can score."""
    rng = np.random.default_rng(3)
    samples = []
    for i in range(4):
        samples.append({
            'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
            'expr': f'the widget {i}',
            'gt_box': np.asarray([0.3 + 0.1 * i, 0.5, 0.2, 0.3],
                                 np.float32)})
    want = j_evaluate_rec(jgen, samples, TOK, SPEC, max_new_tokens=3,
                          batch_size=batch_size)
    got = evaluate_rec(Generator(tmodel, max_len=MAX_LEN), samples, TOK,
                       SPEC, max_new_tokens=3, batch_size=batch_size)
    assert got.keys() == want.keys() and got['total'] == 4
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ----------------------------------------------------------- entry points

def test_worker_serves_the_unquantized_path_by_default():
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('tiny', device='cpu')
    assert worker.quant_type == 'none' and type(worker.generator) is Generator
    rng = np.random.default_rng(0)
    tokens = []
    for temperature in (0.0, 0.7):
        frames = list(worker.generate_stream({
            'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
            'prompt': 'Locate the dog in the image.', 'max_new_tokens': 12,
            'stream_chunk': 4, 'temperature': temperature}))
        assert all(f['error_code'] == 0 for f in frames)
        assert len(frames) >= 2 and 'boxes' in frames[-1]
        tokens.append(worker.generator.last_stats['tokens'])
    frames = list(worker.generate_stream({
        'image': np.zeros((56, 56, 3), np.float32), 'prompt': 'x',
        'max_new_tokens': 256}))
    assert frames[-1]['error_code'] == 1 and 'KV cache' in frames[-1]['text']
    assert worker.status()['queue_length'] == 0


def test_worker_unquantized_engine_branch():
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('tiny', device='cpu', use_engine=True,
                         engine_slots=2, kv_bits=8)
    try:
        assert worker.engine.qp is None and worker.engine._kv_bits == 16
        frames = list(worker.generate_stream({
            'image': np.zeros((56, 56, 3), np.float32),
            'prompt': 'Locate the dog.', 'max_new_tokens': 6}))
        assert frames[-1]['error_code'] == 0 and 'boxes' in frames[-1]
        assert worker.status()['engine']['finished'] == 1
    finally:
        worker.engine.close()


def _png(tmp_path, name='img.png', size=(60, 80)):
    from PIL import Image
    img = (np.random.default_rng(0).uniform(0, 255, size + (3,))
           .astype(np.uint8))
    Image.fromarray(img).save(tmp_path / name)
    return tmp_path / name


def test_run_groma_tiny_defaults(tmp_path, capsys):
    from groma_tpu_torch.eval import run_groma
    path = _png(tmp_path)
    tokens, vis = run_groma.main([
        '--tiny', '--image-file', str(path), '--query', 'Locate the dog.',
        '--max-new-tokens', '6', '--device', 'cpu',
        '--output-image', str(tmp_path / 'out.jpg')])
    assert tokens.shape[0] == 1 and 1 <= tokens.shape[1] <= 6
    assert vis['selected_mask'].any()
    assert capsys.readouterr().out.strip()


def test_cli_on_piped_stdin(tmp_path, monkeypatch, capsys):
    from groma_tpu_torch.serve import cli
    path = _png(tmp_path)
    monkeypatch.setattr('sys.stdin',
                        io.StringIO('Locate the dog.\nAnd the cat?\n'))
    cli.main(['--model-dir', 'tiny', '--image-file', str(path),
              '--max-new-tokens', '4', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('ASSISTANT: ') == 2


def test_eval_rec_cli_tiny(tmp_path, capsys):
    from groma_tpu_torch.eval import eval_rec
    images, anns = [], []
    for i in range(3):
        _png(tmp_path, f'{i}.png', (40 + 10 * i, 50))
        images.append({'id': i, 'file_name': f'{i}.png', 'height': 40 + 10 * i,
                       'width': 50, 'caption': f'the thing {i}'})
        anns.append({'id': i, 'image_id': i, 'category_id': 1,
                     'bbox': [5.0, 6.0, 20.0, 15.0]})
    ann_file = tmp_path / 'refs.json'
    ann_file.write_text(json.dumps({'images': images, 'annotations': anns,
                                    'categories': [{'id': 1}]}))
    out = eval_rec.main(['--model-dir', 'tiny', '--tokenizer', 'stub',
                         '--img-prefix', str(tmp_path), '--ann-file',
                         str(ann_file), '--batch-size', '2',
                         '--device', 'cpu'])
    assert out['total'] == 3
    assert json.loads(capsys.readouterr().out.strip()) == out


def test_random_unquantized_draws_random_groma_weights():
    """One seed, one set of full-precision weights: the unquantized random
    model's trunk is the quantized random model's before quantization."""
    from groma_tpu_torch.checkpoint.loader import random_groma
    from groma_tpu_torch.models.llama_quant import quantize_llama_layer
    cfg = CFG.replace(llm=CFG.llm.replace(dtype='bfloat16'))
    model = random_groma_unquantized(cfg, seed=1)
    _, qp = random_groma(cfg, seed=1, bits=16)
    layer = model.llm.model.layers[1]
    assert layer.self_attn.q_proj.weight.dtype == torch.bfloat16
    want = quantize_llama_layer(layer.state_dict(), 16)
    for k, v in want.items():
        got = qp['layers'][1][k]
        got, v = (got['q'], v['q']) if isinstance(v, dict) else (got, v)
        assert torch.equal(got, v), k


PSUM = """
import json
import sys
import torch.distributed as dist
from groma_tpu_torch.eval.rec import RECMetrics
rank = int(sys.argv[1])
dist.init_process_group('gloo', init_method='tcp://localhost:' + sys.argv[2],
                        rank=rank, world_size=2)
m = RECMetrics(correct=1 + rank, iou_sum=0.5 * rank, missed=rank, total=3)
print(json.dumps(m.psum_across_hosts().summary()))
dist.destroy_process_group()
"""


def test_rec_metrics_sum_over_a_process_group():
    """Two gloo processes: each one's counts become the sum of both."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, '-c', PSUM, str(r), port],
                              env=env, stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want = {'acc@0.5': 3 / 6, 'miou': 0.5 / 6, 'miss_rate': 1 / 6,
            'total': 6}
    assert [json.loads(o) for o in outs] == [want, want]
    assert RECMetrics(total=2).psum_across_hosts().summary()['total'] == 2


def test_rec_summary_is_json_ready_once_a_box_is_predicted():
    """A predicted box makes the IoU sum a numpy f32: the summary still
    gives JAX's values, as Python numbers that ``eval_rec`` can print."""
    from groma_tpu.eval.rec import RECMetrics as JRECMetrics
    gt = np.asarray([0.5, 0.5, 0.4, 0.3], np.float32)
    pred = np.asarray([0.52, 0.48, 0.35, 0.3], np.float32)
    got, want = RECMetrics(), JRECMetrics()
    for m in (got, want):
        m.update(pred, gt)
        m.update(None, gt)
    summary = got.summary()
    assert json.loads(json.dumps(summary)) == summary
    assert summary == {k: float(v) if k != 'total' else v
                       for k, v in want.summary().items()}
