"""Grouped-query attention on the port's quantized path against the JAX
package's.

The LLM has 4 query heads over 2 KV heads (``num_kv_heads = num_heads /
2``), hidden 256 and intermediate 768, so that its bits=4 tree is really
int4 (K in whole 256-row blocks).  ``quant_llama_forward`` at int8 and
int4 weights over an int8 and a float KV cache: a prefill, scalar-index
decode steps, vector-index decode steps (the engine's) and chunked appends
at a scalar and at a vector index, each held to JAX's hidden states within
2e-5 (f32 sums in another order; the int8 cache bytes bitwise).  JAX's
route is the plain chain at ``rep > 1`` (its decode kernel runs only at
``rep == 1``), so no interpreter is needed.  ``QuantGenerator`` (int8 and
int4 weights, int8 KV) and the contiguous ``BatchEngine`` give JAX's greedy
tokens exactly.  The paged engine, ``quant_llama_decode_paged`` and the
megakernel refuse GQA, as JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate_quant import QuantGenerator as JGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama import make_kv_cache as j_float_cache
from groma_tpu.models.llama_quant import make_quant_kv_cache as j_cache
from groma_tpu.models.llama_quant import quant_llama_forward as j_forward
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quantize_groma_llm)
from groma_tpu_torch.models.llama import make_kv_cache
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_decode_paged,
                                                quant_llama_forward)
from groma_tpu_torch.ops import decode_megakernel
from groma_tpu_torch.serve.engine import BatchEngine

torch.set_num_threads(2)

_TINY = tiny_groma_config()
CFG = _TINY.replace(llm=_TINY.llm.replace(
    hidden_size=256, intermediate_size=768, num_heads=4, num_kv_heads=2))
TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.fixture(scope='module')
def models():
    jmodel = JGroma(CFG)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, from_jax_params(params, CFG)


def _caches(kv, b, max_len):
    llm = CFG.llm
    if kv == 8:
        return j_cache(llm, b, max_len), make_quant_kv_cache(llm, b, max_len)
    return j_float_cache(llm, b, max_len), make_kv_cache(llm, b, max_len)


def _same_cache(tc, jc):
    for i in range(CFG.llm.num_layers):
        for key in ('k', 'v', 'k_scale', 'v_scale'):
            if key in jc:
                if tc[key][i].dtype == torch.int8:
                    np.testing.assert_array_equal(tc[key][i].numpy(),
                                                  np.asarray(jc[key][i]))
                else:
                    _close(tc[key][i], jc[key][i])
    np.testing.assert_array_equal(tc['mask'].numpy(), np.asarray(jc['mask']))


@pytest.mark.parametrize('bits,kv', [(8, 8), (4, 8), (8, 16), (4, 16)])
def test_quant_forward_gqa_prefill_and_scalar_decode_match_jax(models, bits,
                                                               kv):
    _, params, tmodel = models
    llm = CFG.llm
    jqp = j_quantize(params, CFG, bits=bits)
    tqp = quantize_groma_llm(tmodel, CFG, bits=bits)
    # the fused qkv narrows to nh * hd + 2 * nkv * hd columns
    assert tqp['layers'][0]['qkv_proj']['q'].shape[-1] == 256 + 2 * 128
    rng = np.random.default_rng(3)
    b, s, max_len = 2, 12, 24
    emb = rng.standard_normal((b, s, llm.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[1, 9:] = False
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0)
    jc, tc = _caches(kv, b, max_len)
    j_fwd = jax.jit(lambda *a: j_forward(a[0], llm, *a[1:]))
    jh, jc = j_fwd(jqp, jnp.asarray(emb), jnp.asarray(valid),
                   jnp.asarray(pos), jc)
    th, tc = quant_llama_forward(tqp, llm, _t(emb), _t(valid), _t(pos), tc)
    _close(th, jh)
    _same_cache(tc, jc)
    next_pos = pos[:, -1:] + 1
    for step in range(3):
        x = rng.standard_normal((b, 1, llm.hidden_size)).astype(np.float32)
        one = np.ones((b, 1), bool)
        jh, jc = j_fwd(jqp, jnp.asarray(x), jnp.asarray(one),
                       jnp.asarray(next_pos + step), jc)
        th, tc = quant_llama_forward(tqp, llm, _t(x), _t(one),
                                     _t(next_pos + step), tc)
        _close(th, jh)
    _same_cache(tc, jc)
    assert tc['index'] == s + 3


@pytest.mark.parametrize('kv', [8, 16])
@pytest.mark.parametrize('mode', ['vector_decode', 'scalar_append',
                                  'vector_append'])
def test_quant_forward_gqa_vector_index_and_chunked_append_match_jax(
        models, kv, mode):
    """A prefill of 10 tokens, then the engine's per-row decode or a
    3-token chunk appended at a scalar or per-row index."""
    _, params, tmodel = models
    llm = CFG.llm
    jqp = j_quantize(params, CFG, bits=8)
    tqp = quantize_groma_llm(tmodel, CFG, bits=8)
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 10, 24
    emb = rng.standard_normal((b, s, llm.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    jc, tc = _caches(kv, b, max_len)
    j_fwd = jax.jit(lambda qp, *a: j_forward(qp, llm, *a))
    j_chunk = jax.jit(lambda qp, *a: j_forward(qp, llm, *a, chunked=True))
    _, jc = j_fwd(jqp, jnp.asarray(emb), jnp.asarray(valid),
                  jnp.asarray(pos), jc)
    _, tc = quant_llama_forward(tqp, llm, _t(emb), _t(valid), _t(pos), tc)
    n = 1 if mode == 'vector_decode' else 3
    idx = np.array([s, s - 3]) if mode.startswith('vector') else s
    if mode.startswith('vector'):
        jc = {**jc, 'index': jnp.asarray(idx, jnp.int32)}
        tc['index'] = torch.as_tensor(idx, dtype=torch.int64)
    x = rng.standard_normal((b, n, llm.hidden_size)).astype(np.float32)
    m = np.ones((b, n), bool)
    p = np.asarray(idx).reshape(-1, 1) + np.arange(n)[None] \
        if mode.startswith('vector') else s + np.broadcast_to(
            np.arange(n), (b, n))
    chunked = mode != 'vector_decode'
    jh, jc = (j_chunk if chunked else j_fwd)(
        jqp, jnp.asarray(x), jnp.asarray(m), jnp.asarray(p), jc)
    th, tc = quant_llama_forward(tqp, llm, _t(x), _t(m), _t(p), tc,
                                 chunked=chunked)
    _close(th, jh)
    _same_cache(tc, jc)
    np.testing.assert_array_equal(np.asarray(tc['index']),
                                  np.asarray(jc['index']))


def _prompt(cfg, text='the dog'):
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    return tok, build_rec_prompt(text, tok, spec)


@pytest.mark.parametrize('bits', [8, 4])
def test_quant_generator_gqa_matches_jax(models, bits):
    jmodel, params, tmodel = models
    tok, t = _prompt(CFG)
    image = np.random.default_rng(0).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)
    args = (image, t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])
    kw = dict(max_new_tokens=8, eos_id=tok.sp.eos)
    max_len = CFG.max_seq_len + 64
    jgen = JGenerator(jmodel, params, j_quantize(params, CFG, bits=bits),
                      max_len=max_len, kv_bits=8)
    j_tokens, _ = jgen.generate(*[jnp.asarray(a) for a in args], **kw)
    tgen = QuantGenerator(tmodel, quantize_groma_llm(tmodel, CFG, bits=bits),
                          max_len=max_len, kv_bits=8)
    t_tokens, _ = tgen.generate(*args, **kw)
    np.testing.assert_array_equal(t_tokens, np.asarray(j_tokens))
    assert t_tokens.shape[1] >= 2


def _serve(engine, reqs):
    try:
        sessions = [engine.submit(*r) for r in reqs]
        return [list(s.token_stream()) for s in sessions]
    finally:
        engine.close()


@pytest.mark.parametrize('bits,kv_bits', [(8, 8), (4, 8), (8, 16)])
def test_contiguous_engine_gqa_matches_jax(models, bits, kv_bits):
    jmodel, params, tmodel = models
    tok, _ = _prompt(CFG)
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(3):
        _, t = _prompt(CFG, f'thing {i}')
        img = rng.standard_normal((56, 56, 3)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    kw = dict(max_slots=2, max_len=CFG.max_seq_len + 14, eos_id=tok.sp.eos,
              chunk=2, max_new_tokens=6, kv_bits=kv_bits)
    want = _serve(JEngine(jmodel, params,
                          qp=j_quantize(params, CFG, bits=bits), **kw), reqs)
    got = _serve(BatchEngine(tmodel, quantize_groma_llm(tmodel, CFG,
                                                        bits=bits), **kw),
                 reqs)
    assert got == want
    assert all(len(g) >= 2 for g in got)


def test_paged_and_megakernel_paths_refuse_gqa(models):
    jmodel, params, tmodel = models
    tqp = quantize_groma_llm(tmodel, CFG, bits=4)
    with pytest.raises(ValueError, match='MHA'):
        BatchEngine(tmodel, tqp, max_slots=2, kv_bits=8, paged_kv=True)
    with pytest.raises(ValueError, match='MHA'):
        JEngine(jmodel, params, qp=j_quantize(params, CFG, bits=4),
                max_slots=2, kv_bits=8, paged_kv=True)
    with pytest.raises(ValueError, match='MHA'):
        quant_llama_decode_paged(tqp, CFG.llm, torch.zeros(1, 1, 256),
                                 torch.zeros(1, 1, dtype=torch.int64),
                                 {}, torch.zeros(1, 1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32))
    assert not decode_megakernel.supported(CFG.llm, 1, tqp)
    mha = CFG.llm.replace(num_heads=2, num_kv_heads=2)
    assert decode_megakernel.supported(mha, 1, tqp)
