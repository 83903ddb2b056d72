"""Prompt-lookup speculative decoding: the port against the JAX package.

* ``propose_prompt_lookup`` equal to JAX's on fixed and random contexts.
* The scalar-index chunked append of ``quant_llama_forward`` (a host int
  and a 0-d device tensor) against JAX's ``chunked=True``, over an int8
  and a float KV cache: hidden states to 1e-4 (the weight-only forward
  test's tolerance), the int8 cache bytes and the masks exactly.
* The verify step (``Verifier``) against JAX's ``make_verify_step`` on the
  same prefilled cache: emitted tokens, n_accept, the next token and
  position, the rewound mask and index exactly.
* ``QuantGenerator(spec_lookahead=4)`` (bf16-path tree, float cache) and
  ``(=3)`` (int8 weights): the tokens of JAX's speculative generator and
  of the port's own sequential greedy decode, with JAX's ``spec_stats``;
  over an int8 cache, JAX's tokens and stats.
* The verify step reads nothing back and sends no host data to a device
  (the guard of ``test_torch_graphs.py``); ``run_groma --spec-lookahead``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval import speculative as j_spec
from groma_tpu.eval.generate_quant import QuantGenerator as JGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama import make_kv_cache as j_fcache
from groma_tpu.models.llama_quant import make_quant_kv_cache as j_qcache
from groma_tpu.models.llama_quant import quant_llama_forward as j_forward
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval import speculative as t_spec
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quant_embed, quant_logits,
                                                 quantize_groma_llm)
from groma_tpu_torch.models.llama import make_kv_cache
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_forward)
from groma_tpu_torch.utils.graphs import StepGraph
from tests.test_torch_graphs import _no_host_io

torch.set_num_threads(2)
TOL = 1e-4
CFG = tiny_groma_config()
LLM = CFG.llm


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope='module')
def params():
    jmodel = JGroma(CFG)
    p = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                    **_dummy_batch(CFG)))()['params']
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope='module')
def trees(params):
    """(JAX, port) quantized LLM trees, bits 16 and 8."""
    tmodel = from_jax_params(params, CFG)
    return {bits: (j_quantize(params, CFG, bits=bits),
                   quantize_groma_llm(tmodel, CFG, bits=bits))
            for bits in (16, 8)}


def test_propose_prompt_lookup_matches_jax():
    cases = [([1, 7, 8, 9, 4, 7, 8], 2, 2), ([7, 8, 1, 7, 8, 2, 7, 8], 2, 2),
             ([5], 3, 2), ([1, 2, 3], 3, 2), ([4, 5, 6, 4, 5], 3, 2),
             ([1, 2, 1, 2], 3, 2), ([3, 1, 4, 1, 5, 9, 2, 6], 4, 1)]
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        cases.append((rng.integers(0, 6, n).tolist(), int(rng.integers(1, 6)),
                      int(rng.integers(1, 4))))
    for ctx, g, ngram in cases:
        want = j_spec.propose_prompt_lookup(ctx, g, ngram)
        got = t_spec.propose_prompt_lookup(ctx, g, ngram)
        assert got == want and len(got) == g, (ctx, g, ngram)


def _caches(kind, b, max_len):
    if kind == 'int8':
        return j_qcache(LLM, b, max_len), make_quant_kv_cache(LLM, b,
                                                              max_len)
    return j_fcache(LLM, b, max_len), make_kv_cache(LLM, b, max_len)


def _prefill(trees, bits, kind, b, s, max_len, seed):
    """Both sides prefilled on the same random stream -> (JAX cache, port
    cache, the stream's positions)."""
    jqp, tqp = trees[bits]
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, s, LLM.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[-1, s - 3:] = False
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0)
    jc, tc = _caches(kind, b, max_len)
    _, jc = jax.jit(lambda *a: j_forward(a[0], LLM, *a[1:]))(
        jqp, jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(pos), jc)
    with torch.no_grad():
        quant_llama_forward(tqp, LLM, _t(emb), _t(valid), _t(pos), tc)
    return jc, tc, pos


def _same_cache(tc, jc, kind):
    np.testing.assert_array_equal(tc['mask'].numpy(), np.asarray(jc['mask']))
    assert int(tc['index']) == int(jc['index'])
    for key in ('k', 'v', 'k_scale', 'v_scale') if kind == 'int8' \
            else ('k', 'v'):
        for got, want in zip(tc[key], jc[key]):
            if kind == 'int8' and key in ('k', 'v'):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want)


@pytest.mark.parametrize('index', ['host', 'device'])
@pytest.mark.parametrize('kind', ['int8', 'float'])
def test_chunked_append_at_a_scalar_index_matches_jax(trees, kind, index):
    b, s, max_len = 2, 10, 24
    jc, tc, pos = _prefill(trees, 8, kind, b, s, max_len, seed=1)
    if index == 'device':
        tc['index'] = torch.tensor(tc['index'], dtype=torch.int64)
    jqp, tqp = trees[8]
    rng = np.random.default_rng(2)
    for chunk in (3, 5):
        x = rng.standard_normal((b, chunk, LLM.hidden_size)).astype(
            np.float32)
        valid = np.ones((b, chunk), bool)
        valid[0, -1] = False
        cpos = pos[:, -1:] + 1 + np.cumsum(valid, -1) - 1
        pos = cpos
        jh, jc = jax.jit(lambda *a: j_forward(a[0], LLM, *a[1:],
                                              chunked=True))(
            jqp, jnp.asarray(x), jnp.asarray(valid), jnp.asarray(cpos), jc)
        with torch.no_grad():
            th, tc = quant_llama_forward(tqp, LLM, _t(x), _t(valid),
                                         _t(cpos), tc, chunked=True)
        _close(th, jh)
        _same_cache(tc, jc, kind)
    assert torch.is_tensor(tc['index']) == (index == 'device')


@pytest.mark.parametrize('kind', ['int8', 'float'])
def test_vector_index_multi_token_append_matches_jax(trees, kind):
    """JAX's per-row multi-token append (the engine's speculative verify):
    rows at different cache indices append S tokens each at their own
    slots, row 2 frozen (its tokens masked out): the hidden states within
    1e-5 of max|hidden|, the int8 cache bytes, the mask and the indices
    equal, the scales and a float cache to 1e-6 (the f32 scale divisions
    round apart in the last bit, as in the prefill)."""
    b, s, max_len = 3, 4, 24
    jc, tc, _ = _prefill(trees, 8, kind, b, 10, max_len, seed=5)
    jqp, tqp = trees[8]
    index = np.asarray([10, 7, 12])
    mask = np.asarray(jc['mask']) & (np.arange(max_len)[None]
                                     < index[:, None])
    jc = {**jc, 'mask': jnp.asarray(mask),
          'index': jnp.asarray(index, jnp.int32)}
    tc['mask'] = _t(mask)
    tc['index'] = _t(index).long()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, LLM.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[2] = False
    cpos = index[:, None] + np.arange(s)[None]
    jh, jc = jax.jit(lambda *a: j_forward(a[0], LLM, *a[1:], chunked=True))(
        jqp, jnp.asarray(x), jnp.asarray(valid), jnp.asarray(cpos), jc)
    with torch.no_grad():
        th, tc = quant_llama_forward(tqp, LLM, _t(x), _t(valid), _t(cpos),
                                     tc, chunked=True)
    want = np.asarray(jh)
    _close(th, want, 1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(tc['mask'].numpy(), np.asarray(jc['mask']))
    np.testing.assert_array_equal(tc['index'].numpy(), index + s)
    np.testing.assert_array_equal(np.asarray(jc['index']), index + s)
    keys = ('k', 'v', 'k_scale', 'v_scale') if kind == 'int8' else ('k', 'v')
    for key in keys:
        for got, ref in zip(tc[key], jc[key]):
            if key in ('k', 'v') and kind == 'int8':
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            else:
                _close(got, ref, 1e-6)


def test_vector_index_multi_token_append_still_raises(trees):
    """Unchunked, as JAX's assert: a multi-token call at an index tensor
    appends only with ``chunked=True``."""
    _, tqp = trees[8]
    cache = make_quant_kv_cache(LLM, 2, 16)
    cache['index'] = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match='must be chunked'):
        quant_llama_forward(tqp, LLM, torch.zeros(2, 3, LLM.hidden_size),
                            torch.ones(2, 3, dtype=torch.bool),
                            torch.zeros(2, 3, dtype=torch.int64), cache)


@pytest.mark.parametrize('kind', ['int8', 'float'])
def test_verify_step_matches_jax(params, trees, kind):
    """Two verifies: a draft whose first token is the greedy one (n_accept
    >= 1, the rest rejected and rewound), then a random one."""
    G, s, max_len = 4, 12, 32
    jc, tc, pos = _prefill(trees, 16, kind, 1, s, max_len, seed=3)
    jgen = JGenerator(JGroma(CFG), params, trees[16][0],
                      max_len=max_len, spec_lookahead=G)
    verifier = t_spec.Verifier(
        trees[16][1], LLM, tc, G,
        lambda qp, ids: quant_embed(qp, ids, LLM.vocab_size), quant_logits)
    cur, pos0 = 17, int(pos[0, -1]) + 1
    verifier.begin(cur, pos0)
    jcur, jpos = jnp.asarray([cur], jnp.int32), jnp.asarray([pos0], jnp.int32)
    # the greedy token after cur, from a verify on a copy of the cache
    probe = jax.tree_util.tree_map(jnp.array, jc)
    _, emitted, _, _, _ = jgen._verify(trees[16][0], probe, jcur,
                                       jnp.zeros(G, jnp.int32), jpos)
    drafts = [[int(emitted[0]), 3, 5, 7],
              np.random.default_rng(4).integers(3, 200, G).tolist()]
    accepted = []
    for draft in drafts:
        jc, jemitted, jn, jcur, jpos = jgen._verify(
            trees[16][0], jc, jcur, jnp.asarray(draft, jnp.int32), jpos)
        emitted, n = verifier(draft)
        np.testing.assert_array_equal(emitted, np.asarray(jemitted))
        assert n == int(jn)
        assert int(verifier.state['cur'][0]) == int(jcur[0])
        assert int(verifier.state['pos0'][0]) == int(jpos[0])
        _same_cache(tc, jc, kind)
        accepted.append(n)
    assert accepted[0] >= 1


def _request(seed=0, cfg=CFG):
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    t = build_rec_prompt('a red thing on the left', tok, VLDataSpec(
        num_image_tokens=cfg.num_image_tokens,
        max_region_num=cfg.max_region_num, max_seq_len=cfg.max_seq_len,
        image_size=cfg.perceiver.image_size))
    image = np.random.default_rng(seed).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)
    return tok, (image, t['input_ids'][None], t['region_slot'][None],
                 t['valid'][None])


@pytest.mark.parametrize('G,bits,kv_bits', [(4, 16, 16), (3, 8, 16),
                                            (3, 8, 8)])
def test_speculative_generator_matches_jax_and_sequential(params, trees, G,
                                                          bits, kv_bits):
    tok, args = _request()
    kw = dict(max_new_tokens=10, eos_id=tok.sp.eos)
    max_len = CFG.max_seq_len + 16
    jgen = JGenerator(JGroma(CFG), params, trees[bits][0], max_len=max_len,
                      kv_bits=kv_bits, spec_lookahead=G)
    want, _ = jgen.generate(*[jnp.asarray(a) for a in args], **kw)
    tmodel = from_jax_params(params, CFG)
    seq = QuantGenerator(tmodel, trees[bits][1], max_len=max_len,
                         kv_bits=kv_bits)
    spc = QuantGenerator(tmodel, trees[bits][1], max_len=max_len,
                         kv_bits=kv_bits, spec_lookahead=G)
    sequential, _ = seq.generate(*args, **kw)
    got, _ = spc.generate(*args, **kw)
    np.testing.assert_array_equal(got, want)
    if kv_bits == 16:
        # over an int8 cache the verify attends through the dequantized
        # cache, not the decode kernel's integer arithmetic, so the two
        # agree only up to near-ties (chip_smoke's rule), as in JAX
        np.testing.assert_array_equal(got, sequential)
    assert spc.spec_stats == jgen.spec_stats
    assert spc.spec_stats['verify_calls'] >= 1
    assert spc.last_stats['decode_forwards'] == spc.spec_stats['verify_calls']
    # a second generation reuses the verify step and gives the same tokens
    again, _ = spc.generate(*args, **kw)
    np.testing.assert_array_equal(again, got)


def test_speculation_refuses_a_batch_and_a_cache_it_could_overrun(trees,
                                                                  params):
    tok, args = _request()
    tmodel = from_jax_params(params, CFG)
    gen = QuantGenerator(tmodel, trees[8][1], max_len=CFG.max_seq_len + 12,
                         spec_lookahead=4)
    with pytest.raises(ValueError, match='does not fit the KV cache'):
        gen.generate(*args, max_new_tokens=10, eos_id=tok.sp.eos)
    two = [np.concatenate([a, a]) for a in args]
    with pytest.raises(ValueError, match='single-stream'):
        gen.generate(*two, max_new_tokens=4, eos_id=tok.sp.eos)


def test_verify_step_reads_nothing_back(params, trees, monkeypatch):
    steps = []
    run = StepGraph.run

    def guarded_run(self, n):
        step = self.step

        def checked(st):
            with _no_host_io():
                step(st)
            steps.append(1)
        self.step = checked
        try:
            return run(self, n)
        finally:
            self.step = step
    monkeypatch.setattr(StepGraph, 'run', guarded_run)
    tok, args = _request(seed=1)
    gen = QuantGenerator(from_jax_params(params, CFG), trees[8][1],
                         max_len=CFG.max_seq_len + 16, kv_bits=8,
                         spec_lookahead=3)
    gen.generate(*args, max_new_tokens=8, eos_id=-1)
    assert len(steps) == gen.spec_stats['verify_calls'] >= 2


@pytest.mark.parametrize('quant', [[], ['--quant_type', 'int8',
                                        '--kv-bits', '8']])
def test_run_groma_spec_lookahead(tmp_path, capsys, quant):
    from PIL import Image
    from groma_tpu_torch.eval import run_groma
    img = (np.random.default_rng(0).uniform(0, 255, (60, 80, 3))
           .astype(np.uint8))
    path = tmp_path / 'img.png'
    Image.fromarray(img).save(path)
    tokens, vis = run_groma.main([
        '--tiny', '--image-file', str(path), '--query', 'Locate the dog.',
        '--spec-lookahead', '2', '--max-new-tokens', '6', '--device', 'cpu',
        '--output-image', str(tmp_path / 'out.jpg')] + quant)
    assert tokens.shape[0] == 1 and 1 <= tokens.shape[1] <= 6
    assert vis['selected_mask'].any()
    assert capsys.readouterr().out.strip()
