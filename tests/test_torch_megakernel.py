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

The card kernel's host-side work plan (``megakernel_plan``) is held at
the Vicuna-7B widths and at this file's tiny ones, for 132, 114 and 78 SMs:
exact coverage, equal bytes per CTA to within one box, no box across a
scale block, gate and up tiles paired.  Its ring schedule, described here
(``_producer_stages``, ``_group_events``), is held for properties that
could fail: every stage taken by the consumers that expect it, every cache
row each item reads streamed once, no group ahead of what it knows the
producer to have filled by a ring's length (``_lag_faults``), and the
producer and both consumer groups run as concurrent agents on the ring's
mbarriers (``_run_ring``) without a stale read, an overwrite or a stall;
without the meeting between attention pairs both checks see the stale
read.  The plan's arithmetic emulated on the host in f32 (split K, folds,
splits added in order) against the plain matmul: rtol and atol 1e-5 (the
same sums in another order).
"""

import itertools
import random

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


# ----------------------------------------------- the card kernel's work plan

PLAN_SHAPES = {'7B': (4096, 11008, 32), 'tiny': (256, 512, 2),
               'tiny straddling': (256, 768, 2)}


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('shape', list(PLAN_SHAPES))
def test_megakernel_plan_covers_every_box_once(shape, sms):
    """Every (column tile, 64-row box) of each matrix in exactly one
    segment; every CTA within one box of the others in every phase; no box
    across a scale block of either nibble half (down_proj's block 21
    straddles K/2 = 5504 at 7B); a tile's splits numbered in order, in
    consecutive slots; gate tile j and up tile F/128 + j one unit."""
    d, f, _ = PLAN_SHAPES[shape]
    plan = mk.megakernel_plan(d, f, sms)
    assert len(plan) == 4 and all(len(per_cta) == sms for per_cta in plan)
    for (k, n, paired), per_cta in zip(mk.megakernel_matrices(d, f), plan):
        kh = k // 2
        boxes = kh // mk.BOX_ROWS
        tiles = n // mk.TILE_COLS // (2 if paired else 1)
        if paired:
            assert tiles == f // mk.TILE_COLS
        seen = np.zeros((tiles, boxes), dtype=int)
        units = [sum(b1 - b0 for _, b0, b1, *_ in mine) for mine in per_cta]
        assert max(units) - min(units) <= 1
        flat = [seg for mine in per_cta for seg in mine]
        for slot, (t, b0, b1, split, splits, sl) in enumerate(flat):
            assert sl == slot and 0 <= b0 < b1 <= boxes
            seen[t, b0:b1] += 1
            mine = [seg for seg in flat if seg[0] == t]
            assert len(mine) == splits and mine[split] == flat[slot]
            assert [seg[5] for seg in mine] == list(
                range(mine[0][5], mine[0][5] + splits))
            for r in range(b0 * mk.BOX_ROWS, b1 * mk.BOX_ROWS, mk.BOX_ROWS):
                end = r + mk.BOX_ROWS - 1
                assert r // mk.INT4_BLOCK == end // mk.INT4_BLOCK
                assert (kh + r) // mk.INT4_BLOCK == (kh + end) // mk.INT4_BLOCK
        assert (seen == 1).all()


# The kernel's schedule (csrc/decode_megakernel.cu), described here for the
# tests: its ring depth, the cache rows of an attention stage and the boxes
# of x that the consumers stage at once.
RING_STAGES = 15
CACHE_ROWS = 64


def _fold(row, kh, half, end):
    """Whether the box at packed row ``row`` ends a scale block of the low
    (0) or high (1) half, or ends its segment."""
    return end or (row + mk.BOX_ROWS + half * kh) % mk.INT4_BLOCK == 0


def _item_stages(layer, item, n):
    """An attention item's ring stages: its k stages (k rows with their k
    and v scales and mask entries), then its v stages, CACHE_ROWS rows
    each, over its ``n`` cache rows."""
    return [(kind, layer, item, j0, min(CACHE_ROWS, n - j0))
            for kind in 'kv' for j0 in range(0, n, CACHE_ROWS)]


def _pairs(c, ctas, items):
    """CTA ``c``'s attention items, two at a time: (i0, i0 + ctas), the
    second one beyond ``items`` where the CTA has an odd count."""
    return [(i0, i0 + ctas) for i0 in range(c, items, 2 * ctas)]


def _pair_stages(layer, pair, items, heads, rows):
    return [_item_stages(layer, i, rows[i // heads]) if i < items else []
            for i in pair]


def _weight_stages(plan, c, layer, m, d, f):
    k, _, paired = mk.megakernel_matrices(d, f)[m]
    out = []
    for tile, box0, box1, *_ in plan[m][c]:
        for sub in range(2 if paired else 1):
            col = sub * f + tile * mk.TILE_COLS
            for bx in range(box0, box1):
                end = bx + 1 == box1
                out.append(('w', layer, m, col, bx,
                            _fold(bx * mk.BOX_ROWS, k // 2, 0, end),
                            _fold(bx * mk.BOX_ROWS, k // 2, 1, end)))
    return out


def _producer_stages(plan, c, n_layers, d, f, heads, rows):
    """The stages that CTA ``c``'s producer (``produce``) loads into the
    ring, in its order: ('w', layer, matrix, column, box, fold_lo, fold_hi),
    a weight box and the scale rows it folds; ('k', layer, item, row,
    count), cache rows of item b H + h; ('v', ...), v rows.  A pair's
    stages interleaved one by one, the longer item's rest last
    (``pair_stage``: ring offset k -> (group, stage)).  ``rows[b]``: the
    cache rows that batch row b reads."""
    ctas, out, items = len(plan[0]), [], len(rows) * heads
    for layer in range(n_layers):
        for ph in range(len(mk.PHASES)):
            if ph != 1:
                out += _weight_stages(plan, c, layer, max(ph - 1, 0), d, f)
                continue
            for pair in _pairs(c, ctas, items):
                stages = _pair_stages(layer, pair, items, heads, rows)
                lens = [len(st) for st in stages]
                mn = min(lens)
                for k in range(sum(lens)):
                    if k < 2 * mn:
                        g, j = k % 2, k // 2
                    else:
                        g, j = int(lens[1] > lens[0]), mn + k - 2 * mn
                    out.append(stages[g][j])
    return out


def _group_events(plan, c, n_layers, d, f, heads, rows, meet=True):
    """Each consumer group's ring events in the kernel's order, for groups
    0 and 1 (warps 0-3 and 4-7): ('take', X, stage), ('release', X,
    arrivals) and ('meet', tag), where both groups pass together (a grid
    barrier, ('barrier', layer, phase), or the meeting between two
    attention pairs, ('pair', layer, i0)).  In a matmul phase both groups
    take every stage and each of their four warps arrives once; in
    attention a group takes only its own item's stages, stage j at ring
    offset 2 j + g while both items have stages and the longer one's rest
    after (``take_own``), and its warps arrive twice each.  The matmul
    phases' meetings inside a phase are left out: fewer meetings allow
    more interleavings.  ``meet=False`` leaves out the meeting between
    pairs (the fault it repairs)."""
    ctas, items = len(plan[0]), len(rows) * heads
    ev, it = ([], []), 0
    for layer in range(n_layers):
        for ph in range(len(mk.PHASES)):
            if ph != 1:
                for st in _weight_stages(plan, c, layer, max(ph - 1, 0), d,
                                         f):
                    for g in (0, 1):
                        ev[g].extend([('take', it, st), ('release', it, 4)])
                    it += 1
            else:
                pairs = _pairs(c, ctas, items)
                for n, pair in enumerate(pairs):
                    stages = _pair_stages(layer, pair, items, heads, rows)
                    mn = min(map(len, stages))
                    for g, mine in enumerate(stages):
                        for j, st in enumerate(mine):
                            x = it + (2 * j + g if j < mn else mn + j)
                            ev[g].extend([('take', x, st),
                                          ('release', x, 8)])
                    it += sum(map(len, stages))
                    if meet and n + 1 < len(pairs):
                        for g in (0, 1):
                            ev[g].append(('meet', ('pair', layer, pair[0])))
            if (layer, ph) != (n_layers - 1, len(mk.PHASES) - 1):
                for g in (0, 1):
                    ev[g].append(('meet', ('barrier', layer, ph)))
    return ev


def _between_meetings(ev):
    """A group's events cut at its meetings: (events, the meeting's tag)."""
    out, part = [], []
    for e in ev:
        if e[0] == 'meet':
            out.append((part, e[1]))
            part = []
        else:
            part.append(e)
    return out + [(part, None)]


def _lag_faults(events):
    """The takes at which a group could read a stale fill: a full barrier
    is waited on by parity alone, so the wait for stage X returns on X's
    fill only if the slot's fill of X - RING_STAGES has completed.  A group
    knows that of every stage before one it has taken (the producer fills
    in order) and, after a meeting, of every stage before one that either
    group took.  Returns (group, X, the first stage it cannot vouch for)."""
    faults, known = [], [0, 0]
    for parts in zip(*map(_between_meetings, events)):
        for g, (part, _) in enumerate(parts):
            for e in part:
                if e[0] == 'take':
                    if e[1] - RING_STAGES >= known[g]:
                        faults.append((g, e[1], known[g]))
                    known[g] = max(known[g], e[1] + 1)
        known = [max(known)] * 2
    return faults


def _run_ring(stages, events, pick):
    """The producer and the two consumer groups as concurrent agents over
    the ring's mbarriers, as the hardware keeps them: a full barrier
    completes a phase at each fill and its wait for parity P returns while
    the count of completed phases has the other parity; an empty barrier
    completes a phase at every 8 warp arrivals, and the producer waits on
    it for the fill before the last one of the slot.  ``pick`` chooses the
    next agent ('p', 0 or 1) among those that can move.  Returns the
    faults: a take that read another fill than its own, a fill over a
    stage still held, an end with an agent stuck."""
    n = RING_STAGES
    full, data, empty, arrived = [0] * n, [None] * n, [0] * n, [0] * n
    held, at, filled, faults = [set(), set()], [0, 0], 0, []

    def ready(a):
        if a == 'p':
            return filled < len(stages) and \
                (empty[filled % n] & 1) != ((filled // n) & 1) ^ 1
        if at[a] == len(events[a]):
            return False
        e = events[a][at[a]]
        if e[0] == 'take':
            return (full[e[1] % n] & 1) != ((e[1] // n) & 1)
        if e[0] == 'meet':
            o = events[1 - a][at[1 - a]] if at[1 - a] < len(events[1 - a]) \
                else None
            return o is not None and o == e
        return True

    while True:
        movable = [a for a in ('p', 0, 1) if ready(a)]
        if not movable:
            break
        a = pick(movable)
        if a == 'p':
            s = filled % n
            if any(x % n == s for h in held for x in h):
                faults.append(('overwrite', filled))
            data[s], full[s], filled = stages[filled], full[s] + 1, filled + 1
            continue
        e = events[a][at[a]]
        if e[0] == 'take':
            if data[e[1] % n] != e[2]:
                faults.append(('stale', a, e[1]))
            held[a].add(e[1])
        elif e[0] == 'release':
            held[a].discard(e[1])
            arrived[e[1] % n] += e[2]
            if arrived[e[1] % n] == 8:
                arrived[e[1] % n] = 0
                empty[e[1] % n] += 1
        else:
            at[1 - a] += 1
        at[a] += 1
    if filled < len(stages) or at != [len(events[0]), len(events[1])]:
        faults.append(('stuck', filled, tuple(at)))
    return faults


def _rows(s, pos, masked):
    """The cache rows each of B rows reads: all S for the fully masked row,
    the positions before pos for the others."""
    return [s if b == masked else pos for b in range(B)]


# (S, pos, the fully masked row): the decode path's slot beside a fully
# masked row (20 and 32 stages an item), and a short row beside one (2
# and 32), the skew at which a group that does not wait for the other
# runs a ring's length ahead of it
RING_ROWS = {'pos580 row7': (1024, 580, 7), 'pos64 row3': (1024, 64, 3)}


@pytest.mark.parametrize('rows', list(RING_ROWS))
@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('shape', list(PLAN_SHAPES))
def test_megakernel_ring_order(shape, sms, rows):
    """For 2 layers: every stage that a CTA's producer loads is taken by
    the consumers that the kernel's order says (both groups in a matmul
    phase, the item's group in attention), holding the stage it expects;
    no group takes a stage whose slot's previous fill it cannot know to be
    complete (``_lag_faults``), and none holds a stage at a meeting; 5 L -
    1 grid barriers; the weight boxes fold at every scale block's end and
    at each segment's end and nowhere else, each pair segment loads its
    gate and its up boxes; the CTAs' k and v stages cover every cache row
    that each (layer, b, head) reads exactly once."""
    d, f, heads = PLAN_SHAPES[shape]
    s, pos, masked = RING_ROWS[rows]
    n_layers = 2
    reads = _rows(s, pos, masked)
    plan = mk.megakernel_plan(d, f, sms)
    mats = mk.megakernel_matrices(d, f)
    cover = {kind: np.zeros((n_layers, B * heads, s), dtype=int)
             for kind in 'kv'}
    for c in range(sms):
        stages = _producer_stages(plan, c, n_layers, d, f, heads, reads)
        events = _group_events(plan, c, n_layers, d, f, heads, reads)
        takers = [[] for _ in stages]
        for g, ev in enumerate(events):
            for e in ev:
                if e[0] == 'take':
                    assert e[2] == stages[e[1]], (c, g, e)
                    takers[e[1]].append(g)
        assert all(t == ([0, 1] if st[0] == 'w' else [0]) or
                   (st[0] != 'w' and t in ([0], [1]))
                   for t, st in zip(takers, stages))
        assert not _lag_faults(events), (c, _lag_faults(events)[:3])
        for ev in events:
            held = set()
            for e in ev:
                if e[0] == 'take':
                    held.add(e[1])
                elif e[0] == 'release':
                    held.remove(e[1])
                else:
                    assert not held
            assert not held
        tags = [[e[1] for e in ev if e[0] == 'meet'] for ev in events]
        assert tags[0] == tags[1]
        assert [t[1:] for t in tags[0] if t[0] == 'barrier'] == [
            (lyr, ph) for lyr in range(n_layers) for ph in range(5)][:-1]
        for st in stages:
            if st[0] in 'kv':
                _, lyr, item, j0, cnt = st
                cover[st[0]][lyr, item, j0:j0 + cnt] += 1
                continue
            _, lyr, m, col, bx, lo, hi = st
            k, _, paired = mats[m]
            kh, r = k // 2, bx * mk.BOX_ROWS
            seg = [sg for sg in plan[m][c]
                   if (col % f if paired else col) // mk.TILE_COLS == sg[0]
                   and sg[1] <= bx < sg[2]]
            assert len(seg) == 1
            end = bx + 1 == seg[0][2]
            assert lo == (end or (r + mk.BOX_ROWS) % mk.INT4_BLOCK == 0)
            assert hi == (end or (kh + r + mk.BOX_ROWS) % mk.INT4_BLOCK
                          == 0)
        for m, (_, _, paired) in enumerate(mats):
            if paired:
                for tile, b0, b1, *_ in plan[m][c]:
                    for layer in range(n_layers):
                        got = [st[3] for st in stages if st[0] == 'w'
                               and st[1:3] == (layer, m)
                               and st[3] % f // mk.TILE_COLS == tile]
                        want = [sub * f + tile * mk.TILE_COLS
                                for sub in (0, 1) for _ in range(b0, b1)]
                        assert sorted(got) == sorted(want)
    for kind in 'kv':
        for item in range(B * heads):
            n = reads[item // heads]
            assert (cover[kind][:, item, :n] == 1).all()
            assert (cover[kind][:, item, n:] == 0).all()


def _schedules():
    """Agent choices for ``_run_ring``: each fixed priority of the three
    agents, and two seeded random ones."""
    orders = [lambda m, o=o: next(a for a in o if a in m)
              for o in itertools.permutations(('p', 0, 1))]
    rngs = [random.Random(seed) for seed in (0, 1)]
    return orders + [lambda m, r=r: r.choice(m) for r in rngs]


# (shape, CTAs): two attention pairs a CTA (7B at 114 and 78 SMs; the tiny
# config's 16 items on 3 CTAs), and one (7B at 132)
RUN_CASES = {'7B 114': ('7B', 114), '7B 78': ('7B', 78),
             '7B 132': ('7B', 132), 'tiny 3': ('tiny', 3)}


@pytest.mark.parametrize('rows', list(RING_ROWS))
@pytest.mark.parametrize('case', list(RUN_CASES))
def test_megakernel_ring_runs_concurrently(case, rows):
    """One layer of every CTA's schedule run as three concurrent agents
    (``_run_ring``: the producer and the two consumer groups on the ring's
    mbarriers) under every fixed priority and two random choices: every
    take reads its own fill, no fill lands on a held stage, nothing is
    stuck.  Without the meeting between attention pairs, the short row
    beside a fully masked one lets a group read a stale fill, which both
    ``_run_ring`` and ``_lag_faults`` see."""
    shape, sms = RUN_CASES[case]
    d, f, heads = PLAN_SHAPES[shape]
    s, pos, masked = RING_ROWS[rows]
    reads = _rows(s, pos, masked)
    plan = mk.megakernel_plan(d, f, sms)
    stale = 0
    for c in range(sms):
        stages = _producer_stages(plan, c, 1, d, f, heads, reads)
        events = _group_events(plan, c, 1, d, f, heads, reads)
        for pick in _schedules():
            assert not _run_ring(stages, events, pick), c
        unmet = _group_events(plan, c, 1, d, f, heads, reads, meet=False)
        for pick in _schedules():
            faults = _run_ring(stages, unmet, pick)
            # the first fault is the stale read; the rest follow from it
            assert not faults or (faults[0][0] == 'stale'
                                  and _lag_faults(unmet)), (c, faults[:2])
            stale += bool(faults)
    two_pairs = sms * 2 < B * heads
    assert bool(stale) == (two_pairs and rows == 'pos64 row3'), stale


@pytest.mark.parametrize('d,f,m', [(256, 512, 0), (256, 512, 1),
                                   (256, 512, 2), (256, 768, 3)],
                         ids=['qkv', 'o', 'gate_up', 'down straddling'])
def test_megakernel_schedule_computes_the_matmul(d, f, m):
    """The kernel's matmul arithmetic in the plan's order on the host, on 7
    CTAs: each segment's boxes (as the producer's stages give them), the
    low and the high nibble half each into its own f32 partial dot on the
    exact integer weights, folded with the block's scale where the stage
    says; a split tile's partials added in split order (a pair's gate and
    up apart).  Equal to the plain ``_int4_chunk_dot`` within 1e-5 (the
    same sums in another order)."""
    from groma_tpu_torch.ops.quant4 import quantize_weight_int4
    k, n, paired = mk.megakernel_matrices(d, f)[m]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, k)).astype(
        np.float32)).to(torch.bfloat16)
    qd = quantize_weight_int4(torch.from_numpy(
        (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)),
        block=mk.INT4_BLOCK)
    packed, scale = qd['q'], qd['scale']
    kh, rows, cols = k // 2, mk.BOX_ROWS, mk.TILE_COLS
    q = torch.cat([(packed.int() & 0xF) - 8, (packed.int() >> 4) - 8],
                  0).float()
    xf = x.float()
    plan = mk.megakernel_plan(d, f, 7)
    partials = {}
    for c in range(7):
        stages = [st for st in _producer_stages(plan, c, 1, d, f, 1,
                                                [0] * B)
                  if st[0] == 'w' and st[2] == m]
        for tile, b0, b1, split, _, _ in plan[m][c]:
            for sub in range(2 if paired else 1):
                col = sub * f + tile * cols
                cs = slice(col, col + cols)
                acc = torch.zeros((B, cols))
                part = [torch.zeros((B, cols)), torch.zeros((B, cols))]
                mine = [st for st in stages if st[3] == col
                        and b0 <= st[4] < b1]
                assert [st[4] for st in mine] == list(range(b0, b1))
                for _, _, _, _, bx, lo, hi in mine:
                    r = slice(bx * rows, (bx + 1) * rows)
                    part[0] += xf[:, r] @ q[r, cs]
                    part[1] += xf[:, kh + bx * rows:kh + (bx + 1) * rows] \
                        @ q[kh + bx * rows:kh + (bx + 1) * rows, cs]
                    for half, fold in ((0, lo), (1, hi)):
                        if fold:
                            blk = (half * kh + bx * rows) // mk.INT4_BLOCK
                            acc += part[half] * scale[blk, cs]
                            part[half] = torch.zeros((B, cols))
                assert not part[0].any() and not part[1].any()
                partials[(col, split)] = acc
    out = torch.zeros((B, n))
    for (col, _), p in sorted(partials.items()):
        out[:, col:col + cols] += p
    want = mk._int4_chunk_dot(x, packed, scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_phase_split_adds_up():
    """``phase_split`` of made-up stamps: work, tails and barriers per phase
    over the blocks, and their sum the mean block's time."""
    n_layers, blocks = 2, 3
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.integers(1, 1000, (blocks, 2 + 10 * n_layers)), 1)
    t[:, 1] = t[:, -1] + 5                 # the end after the last release
    stamps = torch.from_numpy(t)
    split = mk.phase_split(stamps, n_layers)
    parts = sum(v for key, v in split.items() if key != 'total')
    assert split['total'] == pytest.approx(parts, rel=1e-12)
    arrive = t[:, 2::2].reshape(blocks, n_layers, 5)
    release = t[:, 3::2].reshape(blocks, n_layers, 5)
    assert split['down barrier'] == pytest.approx(
        (release[..., 4].mean(0) - arrive[..., 4].max(0)).sum() / 1e6)
