"""The port's packed-int4 quantization and matmul against the JAX package.

Tolerances:
* packed bytes, scales and every leaf of the quantized LLaMA tree: equal;
* int4 matmul: rtol and atol 1e-5 in f32, against the TPU kernel body in
  the Pallas interpreter (per-block dots on biased nibbles, the
  straddling block split in two) and against the JAX wrapper's CPU path
  (the same f32 dot against the same dequantized weights), both summed in
  another order;
* the decode tile's split plan (``decode_plan``, computed on the host):
  exact coverage of K/2, tiles inside scale blocks, CTAs for every SM;
* the prefill tile's plan (``prefill_plan``, ``prefill_tiles``,
  ``prefill_stages``): every output tile once, every k stage once inside
  one nibble half and one scale block, folds at every block's end; its
  schedule emulated on the host in f32 against the plain matmul, rtol and
  atol 1e-5 (the same sums in another order).
On CPU tensors the wrapper takes the plain version and launches nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from groma_tpu.checkpoint.hf_export import export_llama
from groma_tpu.config import LlamaConfig
from groma_tpu.models.llama_quant import \
    quantize_llama_params as j_quantize_llama
from groma_tpu.ops.quant4 import _int4_matmul_kernel
from groma_tpu.ops.quant4 import int4_matmul as j_int4_matmul
from groma_tpu.ops.quant4 import quantize_weight_int4 as j_quantize
from groma_tpu_torch.models.llama_quant import \
    quantize_llama_params as t_quantize_llama
from groma_tpu_torch.ops.quant4 import (DECODE_CTAS_PER_SM, DECODE_TILE,
                                        INT4_BLOCK, PREFILL_STAGE_ROWS,
                                        PREFILL_TILE, decode_plan,
                                        dequantize_weight_int4, int4_matmul,
                                        int4_matmul_reference, prefill_plan,
                                        prefill_stages, prefill_tiles,
                                        quantize_weight_int4)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('block,pad_to', [(128, 0), (256, 0), (256, 64)])
def test_quantize_weight_int4_matches_jax(rng, block, pad_to):
    w = rng.standard_normal((512, 150)).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    want = j_quantize(jnp.asarray(w), block=block, pad_to=pad_to)
    got = quantize_weight_int4(_t(w), block=block, pad_to=pad_to)
    assert got['q'].dtype == torch.uint8 and got['block'] == block
    assert got['q'].shape == want['q'].shape == (256, 192 if pad_to else 150)
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_array_equal(got['scale'].numpy(),
                                  np.asarray(want['scale']))
    # the round trip stays within half a quantization step
    back = dequantize_weight_int4(got)[:, :150].numpy()
    step = np.repeat(got['scale'].numpy(), block, axis=0)[:, :150]
    assert (np.abs(back - w) <= 0.5 * step + 1e-6).all()


def _tpu_kernel_body(x, packed, scale):
    """``_int4_matmul_kernel`` through the Pallas interpreter, one block
    over the whole arrays, f32 out: its split of the straddling block and
    its dot on biased nibbles minus 8 sum(x) run as on the TPU."""
    m, n = x.shape[0], packed.shape[1]
    return pl.pallas_call(
        functools.partial(_int4_matmul_kernel, block=INT4_BLOCK),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        interpret=True)(x, packed, scale)


@pytest.mark.parametrize('m', [1, 5, 8, 64, 130])   # 130: two token tiles
@pytest.mark.parametrize('k', [512, 768])    # 768: block 1 straddles K/2
def test_int4_matmul_reference_matches_jax(rng, m, k):
    """Against the TPU kernel body, and against the JAX wrapper's CPU path
    (dequantize, f32 dot)."""
    n = 192
    # bf16 values, as the kernel takes them
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
                   .astype(jnp.float32))
    # weights of a trained layer's scale, N(0, 1/K): outputs of order 1
    w = rng.standard_normal((k, n)) / np.sqrt(k)
    qd = j_quantize(jnp.asarray(w, jnp.float32), block=INT4_BLOCK)
    got = int4_matmul_reference(_t(x), _t(qd['q']), _t(qd['scale'])).numpy()
    body = np.asarray(_tpu_kernel_body(jnp.asarray(x, jnp.bfloat16),
                                       qd['q'], qd['scale']))
    np.testing.assert_allclose(got, body, rtol=1e-5, atol=1e-5)
    want = np.asarray(j_int4_matmul(jnp.asarray(x), qd['q'], qd['scale'],
                                    block=INT4_BLOCK, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(
        int4_matmul(_t(x), _t(qd['q']), _t(qd['scale'])).numpy(), got)


# (K, N) of the int4 tree's matmuls at 7B width (chip_smoke's shapes) and
# the tiny ones of these tests (N % 128 = 64: a half-empty column tile)
_PLAN_SHAPES = {'qkv_proj': (4096, 12288), 'o_proj': (4096, 4096),
                'gate_up_proj': (4096, 22016), 'down_proj': (11008, 4096),
                'lm_head': (4096, 32256), 'tiny': (512, 192),
                'tiny straddling': (768, 192)}


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('m', [1, 8])
@pytest.mark.parametrize('shape', list(_PLAN_SHAPES))
def test_decode_plan_covers_k_once_inside_scale_blocks(shape, m, sms):
    """The decode tile's split of the K/2 packed rows: whole 64-row tiles,
    each packed row in exactly one split, no split empty, at most one wave
    of CTAs, every tile inside one scale block of each nibble half
    (down_proj's block 21 straddles K/2 = 5504), and at least one CTA per
    SM where the shape has that many tiles."""
    k, n = _PLAN_SHAPES[shape]
    kh = k // 2
    rows, cols = DECODE_TILE
    split_rows, splits = decode_plan(k, n, sms)
    assert split_rows % rows == 0 and split_rows > 0
    seen = np.zeros(kh, dtype=int)
    for s in range(splits):
        lo, hi = s * split_rows, min((s + 1) * split_rows, kh)
        assert lo < hi
        seen[lo:hi] += 1
        for r in range(lo, hi, rows):
            assert r // INT4_BLOCK == (r + rows - 1) // INT4_BLOCK
            assert (kh + r) // INT4_BLOCK == (kh + r + rows - 1) // INT4_BLOCK
    assert (seen == 1).all()
    col_tiles = -(-n // cols)
    assert col_tiles * splits >= min(sms, col_tiles * kh // rows)
    assert splits == 1 or col_tiles * splits <= DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize('m', [9, 200, 2048, 4096])
@pytest.mark.parametrize('shape', list(_PLAN_SHAPES))
def test_prefill_plan_covers_every_tile_and_stage_once(shape, m):
    """The prefill tile's persistent grid: every (token tile, column tile)
    in exactly one CTA, no CTA idle, at most one CTA per SM, the CTAs in
    flight on few column tiles (tokens fastest); its k stages: K covered
    once, the packed rows of each nibble half once, every stage inside one
    half and one scale block, a fold where a block or a half ends and
    nowhere else (down_proj's block 21 folds at K/2 and again at its end)."""
    k, n = _PLAN_SHAPES[shape]
    tok, cols = PREFILL_TILE
    for sms in (132, 114, 78):
        ctas, tok_tiles, col_tiles = prefill_plan(m, n, sms)
        assert (tok_tiles, col_tiles) == (-(-m // tok), -(-n // cols))
        assert 1 <= ctas == min(sms, tok_tiles * col_tiles)
        per_cta = prefill_tiles(m, n, sms)
        assert len(per_cta) == ctas and all(per_cta)
        seen = np.zeros((tok_tiles, col_tiles), dtype=int)
        for tiles in per_cta:
            for t, c in tiles:
                seen[t, c] += 1
        assert (seen == 1).all()
        for r in range(max(map(len, per_cta))):
            in_flight = {c for tiles in per_cta if r < len(tiles)
                         for _, c in tiles[r:r + 1]}
            assert len(in_flight) <= -(-ctas // tok_tiles) + 1
    kh, rows = k // 2, PREFILL_STAGE_ROWS
    stages = prefill_stages(k)
    assert [s[0] for s in stages] == list(range(0, k, rows))
    for half in (0, 1):
        packed = sorted(s[1] for s in stages if s[2] == half)
        assert packed == list(range(0, kh, rows))
    for k0, r, half, blk, fold in stages:
        assert half == int(k0 >= kh) and r == k0 - half * kh
        assert blk == k0 // INT4_BLOCK == (k0 + rows - 1) // INT4_BLOCK
        end = k0 + rows
        assert fold == (end % INT4_BLOCK == 0 or end == kh)
    assert stages[-1][4]                      # the last stage folds
    if kh % INT4_BLOCK:                       # the block straddling K/2
        b = kh // INT4_BLOCK
        mine = [s for s in stages if s[3] == b]
        assert {s[2] for s in mine} == {0, 1}
        assert [s[4] for s in mine if s[0] + rows == kh] == [True]


@pytest.mark.parametrize('m,k,n', [(130, 512, 192), (9, 768, 192),
                                   (200, 768, 320)])
def test_prefill_schedule_computes_the_matmul(rng, m, k, n):
    """The prefill tile's arithmetic in its own order on the host: per
    output tile (rows past M and columns past N zero, as TMA fills them),
    per stage the dot of x's 128 k with the stage's nibble half of its
    packed rows on exact integers, folded with the block's scale where
    the plan folds; equal to the plain matmul."""
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    # weights of a trained layer's scale, N(0, 1/K): outputs of order 1
    qd = quantize_weight_int4(_t(rng.standard_normal((k, n)) / np.sqrt(k)),
                              block=INT4_BLOCK)
    packed, scale = qd['q'].to(torch.int32), qd['scale']
    tok, cols = PREFILL_TILE
    rows = PREFILL_STAGE_ROWS
    ctas, tok_tiles, col_tiles = prefill_plan(m, n, 7)
    xp = torch.zeros((tok_tiles * tok, k))
    xp[:m] = x
    pp = torch.zeros((k // 2, col_tiles * cols), dtype=torch.int32)
    pp[:, :n] = packed
    sp = torch.zeros((k // INT4_BLOCK, col_tiles * cols))
    sp[:, :n] = scale
    out = torch.full((m, n), float('nan'))
    for tiles in prefill_tiles(m, n, 7):
        for t, c in tiles:
            xs, cs = slice(t * tok, (t + 1) * tok), slice(c * cols,
                                                         (c + 1) * cols)
            acc = torch.zeros((tok, cols))
            part = torch.zeros((tok, cols))
            for k0, r, half, blk, fold in prefill_stages(k):
                q = ((pp[r:r + rows, cs] >> (4 * half)) & 0xF) - 8
                part += xp[xs, k0:k0 + rows] @ q.float()
                if fold:
                    acc += part * sp[blk, cs]
                    part.zero_()
            keep = min(tok, m - t * tok), min(cols, n - c * cols)
            if keep[1] > 0:
                out[t * tok:t * tok + keep[0],
                    c * cols:c * cols + keep[1]] = acc[:keep[0], :keep[1]]
    want = int4_matmul_reference(x, qd['q'], scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _llama_params(rng, cfg):
    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    d, f = cfg.hidden_size, cfg.intermediate_size
    model = {'norm': {'scale': w(d)}}
    for i in range(cfg.num_layers):
        model[f'layers_{i}'] = {
            'input_layernorm': {'scale': w(d)},
            'post_attention_layernorm': {'scale': w(d)},
            'self_attn': {p: {'kernel': w(d, d)}
                          for p in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            'gate_proj': {'kernel': w(d, f)},
            'up_proj': {'kernel': w(d, f)},
            'down_proj': {'kernel': w(f, d)},
        }
    return {'model': model, 'embed_tokens': w(cfg.vocab_size, d),
            'lm_head': {'kernel': w(d, cfg.vocab_size)}}


@pytest.mark.parametrize('bits,f', [(4, 768), (4, 384), (16, 384)])
def test_quantize_llama_params_matches_jax(rng, bits, f):
    """int4 where K % 256 == 0 (qkv, o, gate_up, the head; down_proj at
    K = 768), int8 elsewhere (down_proj at K = 384), and the bf16 tree;
    the head padded to 512 columns."""
    cfg = LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=f,
                      num_layers=2, num_heads=2, num_kv_heads=2,
                      dtype='float32')
    params = _llama_params(rng, cfg)
    want = j_quantize_llama(params, cfg, bits=bits)
    sd = {k: _t(v) for k, v in export_llama(params, cfg.num_layers).items()}
    got = t_quantize_llama(sd, cfg, bits=bits)

    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(
        got, is_leaf=torch.is_tensor))
    for path, leaf in flat_want:
        node = got
        for p in path:
            node = node[getattr(p, 'key', getattr(p, 'idx', None))]
        ref = np.asarray(leaf)
        val = node.float().numpy() if node.dtype == torch.bfloat16 \
            else node.numpy()
        assert val.shape == ref.shape, path
        np.testing.assert_array_equal(val, ref.astype(val.dtype), str(path))
    layer = got['layers'][0]
    if bits == 4:
        assert layer['qkv_proj']['q'].dtype == torch.uint8
        assert layer['down_proj']['q'].dtype == (
            torch.uint8 if f % INT4_BLOCK == 0 else torch.int8)
        assert got['lm_head']['q'].shape == (128, 512)   # (K/2, padded N)
    else:
        assert layer['qkv_proj']['q'].dtype == torch.bfloat16
        assert got['lm_head']['q'].shape == (256, 512)
    assert all(t.is_contiguous() for t in jax.tree_util.tree_leaves(
        got, is_leaf=torch.is_tensor))


def test_cpu_wrapper_launches_nothing_and_others_refuse(rng):
    before = int4_matmul.launches
    qd = quantize_weight_int4(_t(rng.standard_normal((256, 64))),
                              block=INT4_BLOCK)
    x = _t(rng.standard_normal((3, 256)).astype(np.float32))
    assert torch.equal(int4_matmul(x, qd['q'], qd['scale']),
                       int4_matmul_reference(x, qd['q'], qd['scale']))
    assert int4_matmul.launches == before
    with pytest.raises(ValueError):
        int4_matmul(torch.zeros((2, 256), device='meta'),
                    torch.zeros((128, 64), dtype=torch.uint8, device='meta'),
                    torch.zeros((1, 64), device='meta'))


def test_quant_generator_serves_int4_as_jax(monkeypatch):
    """The worker's non-engine --quant_type int4: QuantGenerator on the
    int4 tree, int8 KV cache, the same greedy tokens and boxes as JAX's.
    The LLM's K values are multiples of 256, so the tree is really int4."""
    from groma_tpu.checkpoint.loader import _dummy_batch
    from groma_tpu.config import tiny_groma_config
    from groma_tpu.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu.eval.generate_quant import QuantGenerator as JGenerator
    from groma_tpu.eval.generate_quant import quantize_groma_llm as j_qgroma
    from groma_tpu.eval.rec import build_rec_prompt
    from groma_tpu.models.groma import GromaModel as JGroma
    from groma_tpu_torch.checkpoint.loader import from_jax_params
    from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                     quantize_groma_llm)
    import groma_tpu.ops.decode_attention as j_decode_attention

    cfg = tiny_groma_config()
    cfg = cfg.replace(llm=cfg.llm.replace(
        hidden_size=256, intermediate_size=768, num_heads=2, num_kv_heads=2))
    jmodel = JGroma(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            **_dummy_batch(cfg)))()['params'])
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    t = build_rec_prompt('the dog', tok, VLDataSpec(
        num_image_tokens=cfg.num_image_tokens,
        max_region_num=cfg.max_region_num, max_seq_len=cfg.max_seq_len,
        image_size=cfg.perceiver.image_size))
    image = np.random.default_rng(0).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)
    args = (image, t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])
    kw = dict(max_new_tokens=6, eos_id=tok.sp.eos)
    # the TPU kernel body in interpret mode: the port's plain order
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    j_tokens, j_vis = JGenerator(
        jmodel, params, j_qgroma(params, cfg, bits=4),
        max_len=cfg.max_seq_len + 64, kv_bits=8).generate(
            *[jnp.asarray(a) for a in args], **kw)
    tmodel = from_jax_params(params, cfg)
    tqp = quantize_groma_llm(tmodel, cfg, bits=4)
    assert tqp['layers'][1]['down_proj']['q'].dtype == torch.uint8
    t_tokens, t_vis = QuantGenerator(tmodel, tqp,
                                     max_len=cfg.max_seq_len + 64,
                                     kv_bits=8).generate(*args, **kw)
    np.testing.assert_array_equal(t_tokens, j_tokens)
    np.testing.assert_array_equal(t_vis['selected_mask'],
                                  j_vis['selected_mask'])
