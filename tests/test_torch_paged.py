"""The port's paged int8 decode attention, page-pool insertion and the two
single-token decode forwards of the engine against the JAX package.

Tolerances:
* paged plain version against the TPU kernel body (Pallas interpreter, the
  same per-page order): 1e-5 x max|out|, plus two requantized-p units of
  any page (the plain version's ``with_step``: the f32 exp and sums of XLA
  and of torch may differ in the last bit, and a p on a .5 tie may then
  round the other way);
* against the JAX oracle (gather + whole-row requantization): 2e-2, as
  ``tests/test_paged_attention.py`` holds the kernel;
* the card kernel's cluster split emulated (each CTA an online softmax
  over a contiguous run of pages, the runs merged by their maxima in rank
  order): against the plain version and against the TPU kernel body in
  the Pallas interpreter, two requantized-p units of any page plus 1e-5 x
  max|out| (a page's p8 is the same under a uniform rescale of its p, up
  to f32 rounding);
* pool bytes and scales after insertion: equal; after a decode write:
  scales 1e-5 and int8 values one unit (k and v come out of f32 products
  summed in another order, which can move a value across a rounding tie);
* hidden states of the decode forwards: 1e-4 (f32 in another order
  through two layers).  JAX's attention runs its TPU kernel bodies in
  interpret mode there, so both sides requantize p in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
import groma_tpu.ops.paged_attention as j_paged
from groma_tpu.checkpoint.hf_export import export_llama
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.llama_quant import (make_quant_kv_cache as j_qcache,
                                          quant_llama_decode_paged as j_paged_fwd,
                                          quant_llama_forward as j_forward,
                                          quantize_llama_params as j_quantize)
from groma_tpu_torch.models.llama import make_kv_cache
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_decode_paged,
                                                quant_llama_forward,
                                                quantize_llama_params)
from groma_tpu_torch.ops.paged_attention import (
    PAGE, PLAN_CLUSTER, _page_loop, insert_prefill_pages, make_kv_page_pool,
    page_runs, paged_attention_reference, paged_int8_decode_attention,
    paged_int8_decode_attention_plain, paged_plan)

torch.set_num_threads(2)

# a small LLM whose K values are multiples of 256, so bits=4 is really
# int4 (down_proj's K = 768 straddles: block 1 spans K/2 = 384)
LLM4 = tiny_groma_config().llm.replace(hidden_size=256, intermediate_size=768,
                                       num_heads=2, num_kv_heads=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _interpreted_paged(q, kp, ks, vp, vs, table, lengths):
    return j_paged._call_kernel(table, lengths, q, kp, ks, vp, vs,
                                interpret=True)


def _paged_inputs(rng, h=4, d=128, pool_pages=16):
    """Rows: ragged over 3 pages, 2 pages + a repeated tail, 1 page + a
    repeated tail, and a frozen row (length 0) on the trash page."""
    np_ = 3
    lengths = np.asarray([3 * PAGE - 17, PAGE + 2, 40, 0], np.int32)
    ids = rng.permutation(pool_pages - 1)[:6] + 1           # never page 0
    table = np.asarray([ids[0:3], [ids[3], ids[4], ids[4]],
                        [ids[5]] * 3, [0, 0, 0]], np.int32)
    q = rng.standard_normal((4, h, 1, d)).astype(np.float32)
    pools = [rng.integers(-127, 128, (pool_pages, h, PAGE, d), dtype=np.int8)
             for _ in range(2)]
    scales = [(rng.random((pool_pages, h, PAGE)) * 0.02 + 1e-3).astype(
        np.float32) for _ in range(2)]
    assert np_ == table.shape[1]
    return (q, pools[0], scales[0], pools[1], scales[1], table, lengths)


def test_paged_plain_matches_tpu_kernel_body(rng):
    args = _paged_inputs(rng)
    want = np.asarray(_interpreted_paged(*[jnp.asarray(a) for a in args]))
    targs = [_t(a) for a in args]
    got, step = paged_int8_decode_attention_plain(*targs, with_step=True)
    got, step = got.numpy(), step.numpy()
    assert got.shape == want.shape == (4, 4, 1, 128)
    assert np.isfinite(got).all()
    tol = 2 * step + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), \
        f'max error {(np.abs(got - want) / step).max():.2f} p8 units'
    # the frozen row is the uniform average over its pages, not 0
    assert np.abs(got[3]).max() > 0
    # against the JAX oracle, whose p is requantized over the whole row
    oracle = np.asarray(j_paged.paged_attention_reference(
        *[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, oracle, atol=2e-2, rtol=2e-2)
    mine = paged_attention_reference(*targs).numpy()
    np.testing.assert_allclose(mine, oracle, atol=2e-2, rtol=2e-2)


def test_cpu_wrapper_takes_the_plain_version(rng):
    targs = [_t(a) for a in _paged_inputs(rng, h=2)]
    before = paged_int8_decode_attention.launches
    assert torch.equal(paged_int8_decode_attention(*targs),
                       paged_int8_decode_attention_plain(*targs))
    assert paged_int8_decode_attention.launches == before
    with pytest.raises(ValueError):
        paged_int8_decode_attention(*[t.to('meta') for t in targs])


@pytest.mark.parametrize('ids', [[3, 5], [6, 0]])
def test_insert_prefill_pages_matches_jax(rng, ids):
    """Compaction included; [6, 0]: the second page is unused and goes to
    the trash page, whose content is not compared."""
    b, h, s, d = 2, 2, 2 * PAGE, 128
    one = {
        'k': [rng.integers(-127, 128, (b, h, s, d), dtype=np.int8)
              for _ in range(2)],
        'v': [rng.integers(-127, 128, (b, h, s, d), dtype=np.int8)
              for _ in range(2)],
        'k_scale': [rng.random((b, h, s)).astype(np.float32)
                    for _ in range(2)],
        'v_scale': [rng.random((b, h, s)).astype(np.float32)
                    for _ in range(2)],
    }
    valid = rng.random(s) < (0.7 if ids[1] else 0.3)
    cfg = LLM4
    want = j_paged.insert_prefill_pages(
        j_paged.make_kv_page_pool(cfg, 8),
        jax.tree_util.tree_map(jnp.asarray, one), row=1,
        page_ids=jnp.asarray(ids, jnp.int32), valid=jnp.asarray(valid))
    got = insert_prefill_pages(
        make_kv_page_pool(cfg, 8), jax.tree_util.tree_map(_t, one), row=1,
        page_ids=torch.as_tensor(ids), valid=_t(valid))
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
    # compaction: the valid positions come first, in order
    n = int(valid.sum())
    flat = got['k'][0][ids[0]].transpose(0, 1).numpy()      # (PAGE, H, D)
    np.testing.assert_array_equal(
        flat[:min(n, PAGE)], one['k'][0][1].transpose(1, 0, 2)[valid][:PAGE])


def _llm(rng, bits):
    cfg = LLM4

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    d, f = cfg.hidden_size, cfg.intermediate_size
    model = {'norm': {'scale': 1 + 0.1 * w(d)}}
    for i in range(cfg.num_layers):
        model[f'layers_{i}'] = {
            'input_layernorm': {'scale': 1 + 0.1 * w(d)},
            'post_attention_layernorm': {'scale': 1 + 0.1 * w(d)},
            'self_attn': {p: {'kernel': w(d, d)}
                          for p in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            'gate_proj': {'kernel': w(d, f)},
            'up_proj': {'kernel': w(d, f)},
            'down_proj': {'kernel': w(f, d)},
        }
    params = {'model': model}
    sd = {k: _t(v) for k, v in export_llama(params, cfg.num_layers).items()}
    return cfg, j_quantize(params, cfg, bits=bits), \
        quantize_llama_params(sd, cfg, bits=bits)


def _assert_written_kv_close(got, want, keys):
    for key in keys:
        for g, w in zip(got[key], want[key]):
            g, w = g.numpy(), np.asarray(w)
            if g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w)
                assert diff.max() <= 1 and (diff > 0).sum() <= 4, key
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('bits,kv_bits', [(4, 8), (8, 16), (16, 16)])
def test_vector_index_decode_matches_jax(rng, monkeypatch, bits, kv_bits):
    """One engine decode step: rows at their own cache index (one of them
    idle at 0), per-row causal mask; int4 weights over an int8 cache, int8
    weights and the bf16 (bits=16) tree over an f32 cache."""
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    cfg, jqp, tqp = _llm(rng, bits)
    b, max_len = 3, 2 * PAGE
    index = np.asarray([5, PAGE + 3, 0], np.int32)
    hd = cfg.hidden_size // cfg.num_heads
    if kv_bits == 8:
        jc = j_qcache(cfg, b, max_len)
        shape = (b, cfg.num_heads, max_len, hd)
        for key, make in (('k', 'int'), ('v', 'int'), ('k_scale', 'scale'),
                          ('v_scale', 'scale')):
            jc[key] = [jnp.asarray(
                rng.integers(-127, 128, shape, dtype=np.int8) if make == 'int'
                else (rng.random(shape[:-1]) * 0.02 + 1e-3).astype(
                    np.float32)) for _ in range(cfg.num_layers)]
        tc = make_quant_kv_cache(cfg, b, max_len)
    else:
        jc = {'k': [], 'v': []}
        for key in ('k', 'v'):
            jc[key] = [jnp.asarray(rng.standard_normal(
                (b, cfg.num_heads, max_len, hd)).astype(np.float32))
                for _ in range(cfg.num_layers)]
        tc = make_kv_cache(cfg, b, max_len)
    for key in ('k', 'v', 'k_scale', 'v_scale')[:4 if kv_bits == 8 else 2]:
        tc[key] = [_t(a) for a in jc[key]]
    mask = np.arange(max_len)[None] < index[:, None]
    jc['mask'], tc['mask'] = jnp.asarray(mask), _t(mask)
    jc['index'], tc['index'] = jnp.asarray(index), _t(index).long()

    emb = rng.standard_normal((b, 1, cfg.hidden_size)).astype(np.float32)
    pos = index[:, None]
    one = np.ones((b, 1), bool)
    jh, jc = jax.jit(lambda *a: j_forward(a[0], cfg, *a[1:]))(
        jqp, jnp.asarray(emb), jnp.asarray(one), jnp.asarray(pos), jc)
    th, tc = quant_llama_forward(tqp, cfg, _t(emb), _t(one), _t(pos), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tc['index'].numpy(), np.asarray(jc['index']))
    np.testing.assert_array_equal(tc['mask'].numpy(), np.asarray(jc['mask']))
    _assert_written_kv_close(tc, jc, ('k', 'v', 'k_scale', 'v_scale')
                             if kv_bits == 8 else ('k', 'v'))


def test_paged_decode_matches_jax(rng, monkeypatch):
    """quant_llama_decode_paged with int4 weights: ragged rows, shuffled
    pages, a repeated table tail and a frozen row on the trash page."""
    monkeypatch.setattr(j_paged, 'paged_int8_decode_attention',
                        _interpreted_paged)
    cfg, jqp, tqp = _llm(rng, 4)
    n_pages, h, hd = 12, cfg.num_heads, cfg.hidden_size // cfg.num_heads
    pools = {}
    for key in ('k', 'v'):
        pools[key] = [rng.integers(-127, 128, (n_pages, h, PAGE, hd),
                                   dtype=np.int8)
                      for _ in range(cfg.num_layers)]
    for key in ('k_scale', 'v_scale'):
        pools[key] = [(rng.random((n_pages, h, PAGE)) * 0.02 + 1e-3).astype(
            np.float32) for _ in range(cfg.num_layers)]
    table = np.asarray([[7, 2, 2], [4, 9, 11], [0, 0, 0]], np.int32)
    pos = np.asarray([[PAGE + 5], [2 * PAGE + 60], [0]], np.int32)
    lengths = np.asarray([pos[0, 0] + 1, pos[1, 0] + 1, 0], np.int32)
    emb = rng.standard_normal((3, 1, cfg.hidden_size)).astype(np.float32)

    jh, jp = jax.jit(lambda *a: j_paged_fwd(a[0], cfg, *a[1:]))(
        jqp, jnp.asarray(emb), jnp.asarray(pos),
        jax.tree_util.tree_map(jnp.asarray, pools), jnp.asarray(table),
        jnp.asarray(lengths))
    th, tp = quant_llama_decode_paged(
        tqp, cfg, _t(emb), _t(pos), jax.tree_util.tree_map(_t, pools),
        _t(table), _t(lengths))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    _assert_written_kv_close(tp, jp, ('k', 'v', 'k_scale', 'v_scale'))


def _cluster_runs(q, kp, ks, vp, vs, table, lengths, c):
    """The card kernel's split: for each row, the CTA of rank r runs the
    page loop over its run [r n / c, (r + 1) n / c) of the row's n pages
    (all NP for a frozen row), a CTA without pages contributes m = -1e30,
    l = 0, acc = 0, and the runs merge in rank order by their maxima."""
    b, h, _, d = q.shape
    out = torch.zeros((b, h, 1, d))
    for bi in range(b):
        length = int(lengths[bi])
        n = min(table.shape[1], -(-length // PAGE)) if length else \
            table.shape[1]
        runs = []
        for lo, hi in page_runs(n, c):
            if lo == hi:
                runs.append((torch.full((h, 1), -1e30), torch.zeros((h, 1)),
                             torch.zeros((h, d))))
                continue
            # positions of the run count from its first page
            sub_len = torch.tensor([max(length - lo * PAGE, 0)])
            m, l, acc, _ = _page_loop(q[bi:bi + 1], kp, ks, vp, vs,
                                      table[bi:bi + 1, lo:hi], sub_len)
            runs.append((m[0], l[0], acc[0]))
        m_star = torch.stack([m for m, _, _ in runs]).amax(0)
        acc = sum(a * torch.exp(m - m_star) for m, _, a in runs)
        l = sum(l_ * torch.exp(m - m_star) for m, l_, _ in runs)
        out[bi, :, 0] = acc / torch.clamp(l, min=1e-30)
    return out


@pytest.mark.parametrize('c', [1, 2, 3, 4])
def test_paged_cluster_runs_match_plain_and_tpu_kernel(rng, c):
    """Rows over 3, 2 and 1 pages and a frozen row (length 0, uniform p
    over all NP pages): at c = 2..4 some rows have fewer pages than CTAs."""
    args = _paged_inputs(rng)
    targs = [_t(a) for a in args]
    want, step = paged_int8_decode_attention_plain(*targs, with_step=True)
    got = _cluster_runs(*targs, c)
    assert torch.isfinite(got).all() and got[3].abs().max() > 0
    tol = 2 * step + 1e-5 * want.abs().max()
    assert ((got - want).abs() <= tol).all(), \
        f'max error {((got - want).abs() / step).max():.2f} p8 units'
    tpu = _t(_interpreted_paged(*[jnp.asarray(a) for a in args]))
    assert ((got - tpu).abs() <= 2 * step + 1e-5 * tpu.abs().max()).all()


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('b,np_', [(8, 19), (8, 20), (1, 19), (4, 5),
                                   (8, 1)])
def test_paged_plan_covers_each_page_once(b, np_, sms):
    """At the 7B shapes (H = 32, 128-token pages, the engine's 8 slots and
    19-page tables): a cluster of 1..PLAN_CLUSTER CTAs and at most NP, and
    for every row length the runs cover its pages once, in order."""
    c = paged_plan(b, 32, np_, sms)
    assert 1 <= c <= min(PLAN_CLUSTER, np_)
    for n in range(np_ + 1):
        runs = page_runs(n, c)
        assert len(runs) == c
        assert [p for lo, hi in runs for p in range(lo, hi)] == \
            list(range(n))
