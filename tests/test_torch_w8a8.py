"""W8A8 and the int8 vision convs: the port against the JAX package.

The ops (``quantize_act``, ``w8a8_matmul``, ``w8a8_conv``) are held bit
for bit on inputs made from a seed with numpy, all-zero rows included; the
conv's card route (an int8 im2col matrix through ``torch._int_mm``) on
the CPU against the plain sums.  The modules (the region encoder and
``prepare_stream`` under ``vision_int8``; ``quant_llama_forward`` with
``w8a8`` and ``use_flash``, both sides on their flash branches, JAX's
kernel in interpret mode) are held to 1e-4, the tolerance of the port's
float region-encoder and weight-only forward tests; weights reach the port
through ``from_jax_params`` and ``quantize_groma_llm``.  The generator must
give JAX's greedy tokens (the engine's W8A8 prefill is held to JAX's
engine in ``test_torch_engine.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.data.tokenizer import StubTokenizer
from groma_tpu.eval.generate_quant import QuantGenerator as JGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models import groma as j_groma
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama_quant import quant_llama_forward as j_forward
from groma_tpu.ops import quant as jq
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quantize_groma_llm)
from groma_tpu_torch.models import groma as t_groma
from groma_tpu_torch.models import llama_quant
from groma_tpu_torch.models.llama_quant import (W8A8_MATMULS,
                                                quant_llama_forward,
                                                w8a8_weights)
from groma_tpu_torch.ops import quant as tq

torch.set_num_threads(2)
TOL = 1e-4
CFG = tiny_groma_config(vision_int8=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _equal(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.fixture(scope='module')
def params():
    jmodel = JGroma(CFG)
    p = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                    **_dummy_batch(CFG)))()['params']
    return jax.tree_util.tree_map(np.asarray, p)


# ------------------------------------------------------------------- ops

def _rows(seed, m, k, zero_rows=(3,)):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32) * 3
    x[list(zero_rows)] = 0.0
    return x


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_act_is_jax_bit_for_bit(dtype):
    x = _rows(0, 37, 72)
    q, s = jq.quantize_act(jnp.asarray(x, dtype))
    tq_, ts = tq.quantize_act(_t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    assert ts[3] == 1.0 and not tq_[3].any()


@pytest.mark.parametrize('layout', ['row-major', 'k-major'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_w8a8_matmul_is_jax_bit_for_bit(dtype, layout):
    x = _rows(1, 300, 96, zero_rows=(0, 150))
    w = np.random.default_rng(2).standard_normal((96, 40)).astype(np.float32)
    w[:, 7] = 0.0                                  # an all-zero column
    wq, s = jq.quantize_weight(jnp.asarray(w))
    want = jq.w8a8_matmul(jnp.asarray(x, dtype), wq, s)
    tw = _t(wq)
    if layout == 'k-major':
        tw = tq.w8a8_weight(tw)
        assert tw.stride() == (1, 96)
    got = tq.w8a8_matmul(_t(x).to(getattr(torch, dtype)), tw, _t(s))
    assert got.dtype == getattr(torch, dtype)
    _equal(got, np.asarray(want.astype(jnp.float32)))
    assert not got[0].any() and not got[150].any()


def _conv_case(seed, b, c, hw, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    return x, k


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _oihw(k):
    return _t(k).permute(3, 2, 0, 1)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,c,hw,co', [(1, 16, 8, 24), (2, 8, 5, 16),
                                       (3, 24, 4, 8)])
def test_w8a8_conv_is_jax_bit_for_bit(b, c, hw, co, dtype):
    """f32 and bf16 activations and kernels (the served vision runs bf16:
    the quantization divides in f32 all the same)."""
    x, k = _conv_case(3, b, c, hw, co)
    want = jq.w8a8_conv(jnp.asarray(x, dtype), jnp.asarray(k, dtype),
                        (1, 1), ((1, 1), (1, 1)))
    tdt = getattr(torch, dtype)
    got = tq.w8a8_conv(_nchw(x).to(tdt), _oihw(k).to(tdt))
    _equal(got.permute(0, 2, 3, 1), want)


def test_w8a8_conv_slices_and_concatenation_are_jax_bit_for_bit():
    """A fuse conv's pieces against its kernel's input-channel slices, and
    the RoI head's one conv over the levels' concatenation."""
    rng = np.random.default_rng(4)
    pieces = [rng.standard_normal((1, 6, 6, c)).astype(np.float32) * s
              for c, s in ((16, 1.0), (8, 4.0), (8, 0.25))]
    k = (rng.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32)
    off = 0
    for p in pieces:
        c = p.shape[-1]
        want = jq.w8a8_conv(jnp.asarray(p), jnp.asarray(k[:, :, off:off + c]),
                            (1, 1), ((1, 1), (1, 1)))
        got = tq.w8a8_conv(_nchw(p), _oihw(k)[:, off:off + c])
        _equal(got.permute(0, 2, 3, 1), want)
        off += c
    cat = np.concatenate(pieces, -1)
    want = jq.w8a8_conv(jnp.asarray(cat), jnp.asarray(k), (1, 1),
                        ((1, 1), (1, 1)))
    got = tq.w8a8_conv(torch.cat([_nchw(p) for p in pieces], 1), _oihw(k))
    _equal(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize('b,c,hw,co', [(2, 16, 7, 24), (1, 8, 3, 16)])
def test_conv_card_route_gives_the_plain_sums(b, c, hw, co):
    """The card's product (torch._int_mm, here on the CPU) over the int8
    im2col matrix gives the plain version's int32 sums."""
    x, k = _conv_case(5, b, c, hw, co)
    xq, xs = tq.quantize_tensor(_nchw(x))
    kq, ks = tq.quantize_conv_kernel(_oihw(k))
    acc = tq._im2col_products(xq, kq)
    assert torch.equal(acc, tq.conv_sums_reference(xq, kq))
    got = tq._rescale_channels(acc, xs, ks).reshape(b, hw, hw, co)
    want = tq.w8a8_conv_reference(_nchw(x), _oihw(k))
    _equal(got, want.permute(0, 2, 3, 1))


def test_card_shape_rules_raise():
    for m, k, n in ((16, 64, 64), (64, 60, 64), (64, 64, 36)):
        with pytest.raises(ValueError, match='_int_mm'):
            tq._int_mm_shapes('w8a8_matmul', m, k, n)
    with pytest.raises(ValueError, match='device'):
        tq.w8a8_matmul(torch.zeros(32, 8, device='meta'),
                       torch.zeros(8, 8, dtype=torch.int8),
                       torch.ones(8))


# -------------------------------------------------------- vision_int8

def _prompt(cfg):
    tok = StubTokenizer(base_vocab=cfg.llm.vocab_size)
    t = build_rec_prompt('the dog', tok, VLDataSpec(
        num_image_tokens=cfg.num_image_tokens,
        max_region_num=cfg.max_region_num, max_seq_len=cfg.max_seq_len,
        image_size=cfg.perceiver.image_size))
    return tok, t


def _vision_int8(m, image, ids, slot, valid, boxes):
    hidden = m.perceiver.encode_image(image)
    mlvl = [h[:, 1:] for h in hidden[-3:]]
    return m.region_encoder(mlvl, boxes), m.prepare_stream(image, ids, slot,
                                                           valid)


def test_region_encoder_and_stream_with_vision_int8_match_jax(params):
    jmodel = JGroma(CFG)
    tmodel = from_jax_params(params, CFG)
    assert tmodel.region_encoder.quant
    rng = np.random.default_rng(1)
    image = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    boxes = rng.uniform(0.05, 0.95, (1, CFG.max_region_num, 4)).astype(
        np.float32)
    _, t = _prompt(CFG)
    inputs = (image, t['input_ids'][None], t['region_slot'][None],
              t['valid'][None], boxes)
    want = jax.jit(lambda p, *a: jmodel.apply(
        {'params': p}, *a, method=_vision_int8))(params, *inputs)
    with torch.no_grad():
        got = _vision_int8(tmodel, *[_t(a) for a in inputs])
    _close(got[0], want[0])
    emb, ids, valid, vis = want[1]
    temb, tids, tvalid, tvis = got[1]
    np.testing.assert_array_equal(tvis['selected_mask'].numpy(),
                                  np.asarray(vis['selected_mask']))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    _close(tvis['region_tokens'], vis['region_tokens'])
    _close(temb, emb)
    # the int8 path is not the float one
    fmodel = from_jax_params(params, CFG.replace(vision_int8=False))
    with torch.no_grad():
        fl = _vision_int8(fmodel, *[_t(a) for a in inputs])[0]
    assert not torch.allclose(fl, got[0], atol=TOL, rtol=TOL)


# ------------------------------------------------------------- the LLM

@pytest.mark.parametrize('mode', ['w8a8', 'w8a8-kmajor', 'flash'])
def test_quant_llama_forward_w8a8_and_flash_match_jax(params, mode,
                                                      monkeypatch):
    """A prefill of B=1 at S=1024 (flash, at FLASH_MIN_SEQ) or B=2 at S=160
    (W8A8 from 256 rows, on the stored weights or on the K-major copies
    of ``w8a8_weights``), into an int8 KV cache, then one decode step.
    Each option alone: with both, the two flash routes' f32 sums in other
    orders move some activations across an int8 rounding step (one
    quantum, 5.6e-4, on 0.18 % of the hidden values), which the
    generator's test holds through its greedy tokens instead."""
    flash, w8a8 = 'flash' in mode, 'w8a8' in mode
    calls = {'w8a8': 0, 'flash': 0}
    kmajor = set()
    real_mm, real_flash = llama_quant.w8a8_matmul, llama_quant.flash_attention

    def mm(*a):
        calls['w8a8'] += 1
        kmajor.add(a[1].stride()[0] == 1)
        return real_mm(*a)

    def fl(*a, **kw):
        calls['flash'] += 1
        return real_flash(*a, **kw)
    monkeypatch.setattr(llama_quant, 'w8a8_matmul', mm)
    monkeypatch.setattr(llama_quant, 'flash_attention', fl)
    llm = CFG.llm
    jqp = j_quantize(params, CFG)
    tqp = quantize_groma_llm(from_jax_params(params, CFG), CFG)
    b, s = (1, 1024) if flash else (2, 160)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((b, s, llm.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, s - 70:] = False                     # a padded tail
    valid[0, 5:9] = False                         # an interior gap
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0)
    from groma_tpu.models.llama_quant import make_quant_kv_cache as j_cache
    from groma_tpu_torch.models.llama_quant import make_quant_kv_cache
    kw = dict(use_flash=flash, w8a8=w8a8)
    jh, jc = jax.jit(lambda *a: j_forward(a[0], llm, *a[1:], **kw))(
        jqp, jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(pos),
        j_cache(llm, b, s + 4))
    tkw = dict(kw, kmajor=w8a8_weights(tqp) if 'kmajor' in mode else None)
    with torch.no_grad():
        th, tc = quant_llama_forward(tqp, llm, _t(emb), _t(valid), _t(pos),
                                     make_quant_kv_cache(llm, b, s + 4),
                                     **tkw)
    _close(th, jh)
    assert calls == {'w8a8': 4 * llm.num_layers if w8a8 else 0,
                     'flash': llm.num_layers if flash else 0}
    # the (K, N) weights: the stored row-major ones or the K-major copies
    assert kmajor == (set() if not w8a8 else {'kmajor' in mode})
    # decode stays weight-only
    x = rng.standard_normal((b, 1, llm.hidden_size)).astype(np.float32)
    one = np.ones((b, 1), bool)
    jh, _ = jax.jit(lambda *a: j_forward(a[0], llm, *a[1:], **kw))(
        jqp, jnp.asarray(x), jnp.asarray(one), jnp.asarray(pos[:, -1:] + 1),
        jc)
    with torch.no_grad():
        th, _ = quant_llama_forward(tqp, llm, _t(x), _t(one),
                                    _t(pos[:, -1:] + 1), tc, **tkw)
    _close(th, jh)
    assert calls['w8a8'] == (4 * llm.num_layers if w8a8 else 0)


@pytest.mark.parametrize('bits', [4, 16])
def test_w8a8_weights_copies_only_int8_layer_weights(params, bits):
    """Packed int4 and bf16 layer weights keep their weight-only products
    under w8a8, as in JAX, so they get no K-major copy; the int8 leaves an
    int4 tree falls back to (K not a multiple of the int4 block) do.  A
    tree without one gets None."""
    tqp = quantize_groma_llm(from_jax_params(params, CFG), CFG, bits=bits)
    int8 = [{n for n in W8A8_MATMULS if lp[n]['q'].dtype == torch.int8}
            for lp in tqp['layers']]
    got = w8a8_weights(tqp)
    if not any(int8):
        assert got is None
    else:
        assert [set(c) for c in got] == int8
    assert bits == 4 or got is None


# ------------------------------------------------------ compact_stream

def test_compact_stream_and_capacity_match_jax():
    rng = np.random.default_rng(7)
    b, s, d = 3, 40, 8
    emb = rng.standard_normal((b, s, d)).astype(np.float32)
    valid = rng.uniform(size=(b, s)) < 0.6
    valid[2] = False                              # an empty row
    ids = rng.integers(0, 100, (b, s))
    out_len = int(valid.sum(-1).max()) + 2
    want = j_groma.compact_stream(jnp.asarray(emb), jnp.asarray(valid),
                                  out_len, jnp.asarray(ids))
    got = t_groma.compact_stream(_t(emb), _t(valid), out_len, _t(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    short = int(valid.sum(-1).max()) - 1
    with pytest.raises(ValueError) as jerr:
        j_groma.check_stream_capacity(jnp.asarray(valid), short)
    with pytest.raises(ValueError) as terr:
        t_groma.compact_stream(_t(emb), _t(valid), short)
    row = int(valid.sum(-1).argmax())
    assert f'row {row} has' in str(terr.value)
    assert str(terr.value).split(';')[0] == str(jerr.value).split(' — ')[0]
    t_groma.check_stream_capacity(_t(valid), out_len)


# ------------------------------------------------------ the generator

def test_quant_generator_w8a8_flash_vision_int8_matches_jax(params):
    """JAX's benchmarked configuration at a 1024-slot stream: the vision
    convs in int8, flash in the ViT and the LLM prefill, the prefill's
    layer matmuls W8A8, an int8 KV cache."""
    cfg = CFG.replace(max_seq_len=1024, box_score_thres=0.0)
    tok, t = _prompt(cfg)
    image = np.random.default_rng(8).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)
    args = (image, t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])
    kw = dict(max_new_tokens=6, eos_id=tok.sp.eos)
    opts = dict(max_len=cfg.max_seq_len + 8, kv_bits=8, use_flash=True,
                w8a8_prefill=True)
    jgen = JGenerator(JGroma(cfg), params, j_quantize(params, cfg), **opts)
    j_tokens, j_vis = jgen.generate(*[jnp.asarray(a) for a in args], **kw)
    tmodel = from_jax_params(params, cfg)
    tgen = QuantGenerator(tmodel, quantize_groma_llm(tmodel, cfg), **opts)
    t_tokens, t_vis = tgen.generate(*args, **kw)
    np.testing.assert_array_equal(t_tokens, j_tokens)
    np.testing.assert_array_equal(t_vis['selected_mask'],
                                  j_vis['selected_mask'])
    np.testing.assert_allclose(t_vis['selected_boxes'],
                               j_vis['selected_boxes'], atol=1e-5)
    assert t_tokens.shape[1] >= 2
    # the K-major copies, made by the constructor, one per layer matmul;
    # the tree, which other generators may share, is left as it was
    assert len(tgen.kmajor) == cfg.llm.num_layers
    for layer, copies in zip(tgen.qp['layers'], tgen.kmajor):
        assert set(copies) == set(W8A8_MATMULS)
        for name, w in copies.items():
            assert w.stride() == (1, w.shape[0])
            assert torch.equal(w, layer[name]['q'])
            assert set(layer[name]) == {'q', 'scale'}
