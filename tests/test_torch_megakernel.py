"""The port's all-layer decode step (``ops.decode_megakernel``) and
``quant_llama_decode_megakernel`` against the JAX package's megakernel,
run by the Pallas interpreter, on the same seeded weights, cache and
inputs; and both against the per-layer decode.

The JAX test's config (hidden 256, 2 heads of 128, 2 layers, 8 rows, 256
slots), with intermediate 512 and 768; at 768, down_proj's scale block 1
(rows 256..511) straddles K/2 = 384.  The cache mask is ragged (row 1 has
masked old positions) and row 7 is fully masked (its current token and
every old position), so its softmax is uniform over all S positions.

Tolerances, measured on this config and stated with their reason:
* hidden state (f32, before the final norm) against JAX, every row: 1e-5
  x max|hidden| (measured at most 5.2e-7).  Both run the same algebra in
  f32; sums in another order, and exp in another library, differ in the
  last bits, and could move a requantized p or a freshly quantized k/v
  byte across a rounding tie;
* the written cache column: int8 within one unit (a k/v value on such a
  tie), at most 1 % of the bytes (measured: none differ), scales 1e-5
  relative;
* untouched cache positions: bitwise, the tail beyond the written slots
  exactly zero;
* against the per-layer decode (bf16 per-layer residual, XLA's fp32
  dequant matmuls on the CPU): the JAX test's bounds, max 0.15, mean 0.02
  (measured at most 0.040 and 0.0069).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_megakernel as j_mk
from groma_tpu.checkpoint.hf_export import export_llama
from groma_tpu.config import LlamaConfig
from groma_tpu.models.llama import rope_tables as j_rope_tables
from groma_tpu.models.llama_quant import (
    make_quant_kv_cache as j_qcache,
    quant_llama_decode_megakernel as j_decode_megakernel,
    quant_llama_forward as j_forward,
    quantize_llama_params as j_quantize)
from groma_tpu_torch.models.llama_quant import (
    make_quant_kv_cache, quant_llama_decode_megakernel, quant_llama_forward,
    quantize_llama_params)
from groma_tpu_torch.ops import decode_megakernel as mk

torch.set_num_threads(2)

B, PRE, MAXLEN = 8, 12, 256
FULLY_MASKED = 7
HIDDEN_TOL = 1e-5          # relative to max|hidden|
MASKED_OLD = (1, slice(3, 7))    # row 1's masked old positions


def _cfg(f):
    return LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=f,
                       num_layers=2, num_heads=2, num_kv_heads=2,
                       dtype='float32')


def _t(x):
    return torch.from_numpy(np.array(x))


def _valid():
    v = np.ones(B, bool)
    v[FULLY_MASKED] = False
    return v


@pytest.fixture(scope='module', params=[512, 768], ids=['F512', 'F768'])
def setup(request):
    """Seeded int4 trees for both packages and one int8 cache after a
    12-token prefill (JAX's), copied into the port's per-layer cache."""
    cfg = _cfg(request.param)
    rng = np.random.default_rng(7)

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
    jqp = j_quantize(params, cfg, bits=4)
    sd = {k: _t(v) for k, v in export_llama(params, cfg.num_layers).items()}
    tqp = quantize_llama_params(sd, cfg, bits=4)
    emb = (rng.standard_normal((B, PRE, d)) * 0.5).astype(np.float32)
    jcache = j_qcache(cfg, B, MAXLEN)
    _, jcache = j_forward(jqp, cfg, jnp.asarray(emb),
                          jnp.ones((B, PRE), bool),
                          jnp.broadcast_to(jnp.arange(PRE)[None], (B, PRE)),
                          jcache)
    mask = np.asarray(jcache['mask']).copy()
    mask[MASKED_OLD] = False
    mask[FULLY_MASKED] = False
    jcache['mask'] = jnp.asarray(mask)
    return cfg, jqp, tqp, jcache, rng


def _port_cache(cfg, jcache):
    tc = make_quant_kv_cache(cfg, B, MAXLEN)
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        tc[key] = [_t(a) for a in jcache[key]]
    tc['mask'] = _t(jcache['mask'])
    tc['index'] = int(jcache['index'])
    return tc


def _step_inputs(cfg, index, mask, valid):
    kj = np.arange(MAXLEN)
    mask_bias = np.where((kj < index)[None] & mask, 0.0,
                         -1e30).astype(np.float32)
    cur_bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None]
    hd = cfg.hidden_size // cfg.num_heads
    cos, sin = j_rope_tables(jnp.full((B, 1), index, jnp.int32), hd,
                             cfg.rope_theta)
    return (mask_bias, cur_bias, np.asarray(cos[:, 0]),
            np.asarray(sin[:, 0]))


def _assert_column(tkv, jk8, jks, jv8, jvs, li, pos):
    """The column written at ``pos`` against JAX's stacked planes."""
    for tq, ts, jq, js in ((tkv['k'], tkv['k_scale'], jk8, jks),
                           (tkv['v'], tkv['v_scale'], jv8, jvs)):
        got = tq[li][:, :, pos].numpy().astype(np.int32)
        want = np.asarray(jq[li, :, :, pos]).astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, \
            (li, pos, diff.max(), (diff > 0).sum())
        # JAX keeps the scales as (L, H, B, S)
        np.testing.assert_allclose(ts[li][:, :, pos].numpy(),
                                   np.asarray(js[li, :, :, pos]).T,
                                   rtol=1e-5, atol=0)


def test_plain_step_matches_jax_interpreted_kernel(setup):
    """Three steps of fused_decode_step: the port's plain version (the
    wrapper on CPU tensors) against JAX's in the Pallas interpreter."""
    cfg, jqp, tqp, jcache, _ = setup
    jsp = j_mk.stack_decode_params(jqp)
    tsp = mk.stack_decode_params(tqp)
    jst = j_mk.stack_kv_cache(jcache)
    tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
    before = [t.clone() for t in tkv['k']]
    rng = np.random.default_rng(11)
    mask, valid = np.asarray(jcache['mask']).copy(), _valid()
    jk8, jks, jv8, jvs = (jst['k'], jst['k_scale'], jst['v'],
                          jst['v_scale'])
    for step in range(3):
        pos = PRE + step
        x = (rng.standard_normal((B, cfg.hidden_size)) * 0.5).astype(
            np.float32)
        mb, cb, cos, sin = _step_inputs(cfg, pos, mask, valid)
        want, jk8, jks, jv8, jvs = j_mk.fused_decode_step(
            jsp, jnp.asarray(x), jk8, jks, jv8, jvs, jnp.asarray(mb),
            jnp.asarray(cb), jnp.asarray(cos), jnp.asarray(sin), pos,
            eps=cfg.rms_norm_eps, interpret=True)
        got = mk.fused_decode_step(tsp, _t(x), tkv, _t(mb), _t(cb), _t(cos),
                                   _t(sin), pos, eps=cfg.rms_norm_eps)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= HIDDEN_TOL * np.abs(want).max(), (step, err)
        assert np.isfinite(got.numpy()).all()
        for li in range(cfg.num_layers):
            _assert_column(tkv, jk8, jks, jv8, jvs, li, pos)
            # every other position bitwise as it was; the tail stays zero
            cur = tkv['k'][li].clone()
            cur[:, :, PRE:pos + 1] = before[li][:, :, PRE:pos + 1]
            assert torch.equal(cur, before[li])
            assert not tkv['k'][li][:, :, pos + 1:].any()
            assert not tkv['v'][li][:, :, pos + 1:].any()
        mask[:, pos] = valid


def test_fully_masked_row_is_uniform_over_the_cache(setup):
    """Row 7 has no valid position: p = 1 at every one of the S old
    positions and at the current token, so its attention output is the
    requantized average of the v rows, and finite."""
    cfg, _, tqp, jcache, _ = setup
    tsp = mk.stack_decode_params(tqp)
    tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
    captured = {}
    attend = mk._attend

    def spy(q, k, v, k8, ks, v8, vs, mask_bias, cur_bias, scale):
        out = attend(q, k, v, k8, ks, v8, vs, mask_bias, cur_bias, scale)
        # copies: the step writes its column into the cache after this
        captured.setdefault('args', (v, k8, v8.clone(), vs.clone()))
        captured.setdefault('attn', out[0])
        return out
    mk._attend = spy
    try:
        x = np.random.default_rng(3).standard_normal(
            (B, cfg.hidden_size)).astype(np.float32)
        mb, cb, cos, sin = _step_inputs(cfg, PRE, np.asarray(jcache['mask']),
                                        _valid())
        out = mk.fused_decode_step(tsp, _t(x), tkv, _t(mb), _t(cb), _t(cos),
                                   _t(sin), PRE, eps=cfg.rms_norm_eps)
    finally:
        mk._attend = attend
    assert torch.isfinite(out).all()
    v, _, v8, vs = captured['args']
    row = FULLY_MASKED
    v8c, vsc = mk._quant_rows(v[row])
    ps = torch.cat([vs[row], vsc], dim=-1)          # p = 1 everywhere
    r = ps.amax(-1, keepdim=True) / 127.0
    p8 = torch.round(ps / r)
    vals = torch.cat([v8[row].float(), v8c[:, None]], dim=1)
    want = (p8[..., None] * vals).sum(1) * (r / (MAXLEN + 1))
    torch.testing.assert_close(captured['attn'][row], want, rtol=1e-5,
                               atol=1e-6)


def test_decode_megakernel_matches_jax(setup, monkeypatch):
    """quant_llama_decode_megakernel (masks, RoPE tables, final norm, cache
    mask and index built around the step) against JAX's, two steps; the
    JAX kernel runs in the interpreter."""
    cfg, jqp, tqp, jcache, rng = setup
    orig = j_mk.fused_decode_step
    monkeypatch.setattr(j_mk, 'fused_decode_step',
                        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    jsp, tsp = j_mk.stack_decode_params(jqp), mk.stack_decode_params(tqp)
    jst = j_mk.stack_kv_cache(jcache)
    tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
    valid = _valid()[:, None]
    for _ in range(2):
        emb = (rng.standard_normal((B, 1, cfg.hidden_size)) * 0.5).astype(
            np.float32)
        want, jst = j_decode_megakernel(jqp, jsp, cfg, jnp.asarray(emb),
                                        jnp.asarray(valid), jst)
        got, tkv = quant_llama_decode_megakernel(tqp, tsp, cfg, _t(emb),
                                                 _t(valid), tkv)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= HIDDEN_TOL * np.abs(want).max(), err
        assert tkv['index'] == int(jst['index'])
        np.testing.assert_array_equal(tkv['mask'].numpy(),
                                      np.asarray(jst['mask']))


def test_megakernel_decode_matches_per_layer_decode(setup):
    """The megakernel path against the per-layer int8-cache decode on two
    copies of one cache (no masked rows: the per-layer path has no
    current-token bias), within the JAX test's bounds."""
    cfg, _, tqp, jcache, rng = setup
    tsp = mk.stack_decode_params(tqp)
    full = np.asarray(jcache['mask']).copy()
    full[:, :PRE] = True
    caches = []
    for _ in range(2):
        c = _port_cache(cfg, jcache)
        c['mask'] = _t(full)
        caches.append(c)
    per_layer, tkv = caches[0], mk.stack_kv_cache(caches[1])
    one = torch.ones((B, 1), dtype=torch.bool)
    for step in range(3):
        emb = _t((rng.standard_normal((B, 1, cfg.hidden_size)) * 0.5)
                 .astype(np.float32))
        want, per_layer = quant_llama_forward(
            tqp, cfg, emb, one, torch.full((B, 1), PRE + step), per_layer)
        got, tkv = quant_llama_decode_megakernel(tqp, tsp, cfg, emb, one,
                                                 tkv)
        d = (got - want).abs()
        assert d.max() < 0.15 and d.mean() < 0.02, (d.max(), d.mean())
        assert (d > 0.05).float().mean() < 0.01
    assert tkv['index'] == per_layer['index'] == PRE + 3


def test_position_past_the_cache_raises(setup):
    cfg, _, tqp, jcache, _ = setup
    tsp = mk.stack_decode_params(tqp)
    tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
    x = torch.zeros((B, cfg.hidden_size))
    mb, cb = torch.zeros((B, MAXLEN)), torch.zeros((B, 1))
    cs = torch.zeros((B, 128))
    with pytest.raises(ValueError, match='outside'):
        mk.fused_decode_step(tsp, x, tkv, mb, cb, cs, cs, MAXLEN)
    tkv['index'] = MAXLEN
    with pytest.raises(ValueError, match='overflow'):
        quant_llama_decode_megakernel(tqp, tsp, cfg, x[:, None],
                                      torch.ones((B, 1), dtype=torch.bool),
                                      tkv)


def test_stack_unstack_round_trip_shares_buffers(setup):
    cfg, _, tqp, jcache, _ = setup
    cache = _port_cache(cfg, jcache)
    st = mk.stack_kv_cache(cache)
    assert st['table'] is None                       # addresses: CUDA only
    back = mk.unstack_kv_cache(st, cfg.num_layers)
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        assert all(a is b for a, b in zip(back[key], cache[key]))
    assert back['mask'] is cache['mask'] and back['index'] == cache['index']
    with pytest.raises(ValueError):
        mk.unstack_kv_cache(st, cfg.num_layers + 1)
    sp = mk.stack_decode_params(tqp)
    assert sp['ln1'].shape == (cfg.num_layers, cfg.hidden_size)
    assert sp['ln1'].dtype == torch.float32
    assert all(a is lp['down_proj']['q']
               for a, lp in zip(sp['wdn'], tqp['layers']))
    assert mk.supported(cfg, B, tqp) and not mk.supported(cfg, 9, tqp)


def test_wrapper_takes_cpu_or_cuda_only(setup):
    """A tensor on another device is refused, not sent to the plain
    version; the int8 tree is refused by the stacking."""
    cfg, _, tqp, jcache, _ = setup
    tsp = mk.stack_decode_params(tqp)
    tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
    x = torch.zeros((B, cfg.hidden_size), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        mk.fused_decode_step(tsp, x, tkv, x, x, x, x, 0)
    int8 = {'layers': [{**lp, 'qkv_proj': {'q': torch.zeros(
        (4, 4), dtype=torch.int8), 'scale': torch.ones(4)}}
        for lp in tqp['layers']]}
    with pytest.raises(ValueError, match='packed-int4'):
        mk.stack_decode_params(int8)


def test_replaced_buffer_after_stacking_raises(setup):
    """The kernel reads the buffers through the addresses captured when the
    forms were stacked: a list entry replaced afterwards is refused."""
    cfg, _, tqp, jcache, _ = setup
    x = torch.zeros((B, cfg.hidden_size))
    mb, cb = torch.zeros((B, MAXLEN)), torch.zeros((B, 1))
    cs = torch.zeros((B, 128))
    for which in ('cache', 'params'):
        tsp = mk.stack_decode_params(tqp)
        tkv = mk.stack_kv_cache(_port_cache(cfg, jcache))
        if which == 'cache':
            tkv['v_scale'][1] = tkv['v_scale'][1].clone()
        else:
            tsp['wgu'][0] = tsp['wgu'][0].clone()
        with pytest.raises(ValueError, match='replaced after stacking'):
            mk.fused_decode_step(tsp, x, tkv, mb, cb, cs, cs, PRE)
        mk.fused_decode_step(mk.stack_decode_params(tqp),
                             x, mk.stack_kv_cache(tkv), mb, cb, cs, cs, PRE)
