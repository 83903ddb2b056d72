"""The port's H100 probes (``groma_tpu_torch/benchmarks``) against the TPU
probes in ``benchmarks/``: each plain version against its TPU probe kernel
run by the Pallas interpreter on the same inputs, made with numpy.  On CPU
tensors the wrappers take the plain versions and launch nothing.

Tolerances:
* int4 unpack (#10): 1e-5 x max|out|: f32 sums in another order;
* w8a8 and int4-a8 (#11): the activation quantization (int8 values and
  scales) equal to the probe's ``_act_q``; the outputs 1e-5 x max|out|
  apart, plus one xq unit for each x on a rounding tie that the
  interpreted kernel (which divides by multiplying with the reciprocal)
  quantizes one unit apart; the integer dots are exact on both sides;
* decode attention (#12): floor 1e-5 x max|out| (f32 sums of the scales in
  another order); the whole-S and S-blocked bodies two requantized-p units
  per (b, h) row plus 1e-5 x max|out|, as #2's plain version is held: the
  f32 exp of XLA and of torch may differ in the last bit, and a requantized
  probability on a .5 tie may then round the other way.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from groma_tpu.ops.quant import quantize_weight as j_quantize_weight
from groma_tpu.ops.quant4 import quantize_weight_int4 as j_quantize_int4
from groma_tpu_torch.benchmarks import (exp_decode_attn_variants as t_attn,
                                        exp_decode_matmul_m8 as t_mm,
                                        exp_int4_unpack as t_unpack)
from groma_tpu_torch.ops.decode_attention import (
    int8_decode_attention_reference, p8_step)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _load_tpu_probe(name):
    """``benchmarks/<name>.py`` loaded by path.  The scripts read
    sys.argv, put the repository on sys.path and set the JAX compile cache
    when imported; all three are restored."""
    argv, path = sys.argv, list(sys.path)
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    sys.argv = [name]
    try:
        spec = importlib.util.spec_from_file_location(
            f'tpu_probe_{name}', os.path.join(REPO, 'benchmarks', f'{name}.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        sys.path[:] = path
        jax.config.update('jax_compilation_cache_dir', cache[0])
        jax.config.update('jax_persistent_cache_min_compile_time_secs',
                          cache[1])
    return mod


class _Interpreted:
    """``pl`` with every pallas_call run by the Pallas interpreter."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope='module')
def tpu():
    return {name: _load_tpu_probe(name) for name in (
        'exp_int4_unpack', 'exp_decode_matmul_m8',
        'exp_decode_attn_variants')}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------ #10 unpack

@pytest.mark.parametrize('variant', ['A', 'B', 'C'])
def test_int4_unpack_plain_matches_the_tpu_kernel(tpu, monkeypatch, variant):
    """KH=256, N=128: each of _kern_a/_b/_c in the interpreter (one block
    over the whole arrays) against the plain version and the CPU wrapper."""
    mod = tpu['exp_int4_unpack']
    kh, n = 256, 128
    monkeypatch.setattr(mod, 'KHALF', kh)
    rng = np.random.default_rng(10)
    x = np.asarray(jnp.asarray(rng.standard_normal((8, 2 * kh)),
                               jnp.bfloat16).astype(jnp.float32))
    p = rng.integers(0, 256, (kh, n)).astype(np.uint8)
    kern = {'A': mod._kern_a, 'B': mod._kern_b, 'C': mod._kern_c}[variant]
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, n), jnp.float32),
        interpret=True)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p)))
    got = t_unpack.unpack_matmul_reference(_t(x), _t(p)).numpy()
    _close(got, want, f'variant {variant}')
    before = dict(t_unpack.unpack_matmul.launches)
    assert torch.equal(t_unpack.unpack_matmul(_t(x), _t(p), variant),
                       _t(got))
    assert t_unpack.unpack_matmul.launches == before


# ------------------------------------------------------- #11 M=8 matmul

def _m8_inputs(k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((8, k)) * 0.1).astype(np.float32)
    x[3] = 0.0                                       # a zero row: scale 1
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    return x, w


def _kernel_act_q(mod, x):
    """xq as the TPU probe's kernels quantize x in the interpreter."""
    def body(x_ref, q_ref):
        q_ref[:] = mod._act_q(x_ref[:])[0].astype(jnp.int32)
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(jnp.asarray(x)))


def _assert_close_up_to_ties(mod, got, want, x, unit, what):
    """The plain version's act_quant equals the probe's ``_act_q`` (IEEE
    division).  Inside an interpreted kernel XLA divides by multiplying
    with the reciprocal, which can move an x that sits on a rounding tie
    (bf16 values make x / s = n + 1/2 common) by one xq unit: each such
    element may move its row's outputs by one unit, ``unit[m, n]``."""
    xq, xs = mod._act_q(jnp.asarray(x))
    got_q, got_s = t_mm.act_quant(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(xs))
    kq = _kernel_act_q(mod, x)
    flips = kq != np.asarray(xq, np.int32)
    ratio = np.abs(x / np.asarray(xs)[:, None])
    assert (np.abs(kq - np.asarray(xq, np.int32)) <= 1).all()
    assert (np.abs(ratio[flips] % 1 - 0.5) < 1e-5).all(), 'a flip off a tie'
    tol = flips.sum(1)[:, None] * unit + TOL * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= tol).all(), f'{what}: max error {err.max():.3e}'


@pytest.mark.parametrize('k', [512, 768])   # 768: block 1 straddles K/2
def test_w8a8_plain_matches_the_tpu_kernel(tpu, monkeypatch, k):
    mod = tpu['exp_decode_matmul_m8']
    monkeypatch.setattr(mod, 'pl', _Interpreted())
    x, w = _m8_inputs(k, 256, 11)
    wq, sc = (np.asarray(a) for a in j_quantize_weight(jnp.asarray(w)))
    want = np.asarray(mod.w8a8_pallas(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(wq), jnp.asarray(sc),
                                      bn=256))
    got = t_mm.w8a8_reference(_t(x), _t(wq), _t(sc)).numpy()
    xs = t_mm.act_quant(_t(x))[1].numpy()
    unit = xs[:, None] * (np.abs(wq).max(0) * sc)[None, :]
    _assert_close_up_to_ties(mod, got, want, x, unit, f'w8a8 K={k}')
    before = t_mm.w8a8_matmul.launches
    assert torch.equal(t_mm.w8a8_matmul(_t(x), _t(wq), _t(sc)), _t(got))
    assert t_mm.w8a8_matmul.launches == before


@pytest.mark.parametrize('k', [512, 768])   # 768: block 1 straddles K/2
def test_int4_a8_plain_matches_the_tpu_kernel(tpu, monkeypatch, k):
    mod = tpu['exp_decode_matmul_m8']
    monkeypatch.setattr(mod, 'pl', _Interpreted())
    x, w = _m8_inputs(k, 256, 12)
    qd = j_quantize_int4(jnp.asarray(w), block=256)
    packed, scale = np.asarray(qd['q']), np.asarray(qd['scale'])
    want = np.asarray(mod.int4_a8(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(packed), jnp.asarray(scale),
                                  bn=256))
    got = t_mm.int4_a8_reference(_t(x), _t(packed), _t(scale)).numpy()
    xs = t_mm.act_quant(_t(x))[1].numpy()
    unit = xs[:, None] * 8 * scale.max(0)[None, :]   # |nibble - 8| <= 8
    _assert_close_up_to_ties(mod, got, want, x, unit, f'int4-a8 K={k}')
    before = t_mm.int4_a8_matmul.launches
    assert torch.equal(t_mm.int4_a8_matmul(_t(x), _t(packed), _t(scale)),
                       _t(got))
    assert t_mm.int4_a8_matmul.launches == before


# ------------------------------------------------- #12 decode attention

def _attn_inputs(seed, b=2, h=16, s=256, d=128, layers=None):
    rng = np.random.default_rng(seed)
    lead = (layers,) if layers else ()
    k8 = rng.integers(-127, 127, lead + (b, h, s, d)).astype(np.int8)
    v8 = rng.integers(-127, 127, lead + (b, h, s, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 1.1e-2, lead + (b, h, s)).astype(np.float32)
    vs = rng.uniform(1e-3, 1.1e-2, lead + (b, h, s)).astype(np.float32)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[1, ..., s - 64:] = -1e30        # row 1: its last S block masked
    bias[0, ..., 0] = 0.5                # k_floor adds bias[b, 0, 0, 0]
    return q, k8, ks, v8, vs, bias


@pytest.mark.parametrize('body', ['floor', 'mxu', 'mxu_sblk'])
def test_decode_attn_plain_matches_the_tpu_kernel(tpu, monkeypatch, body):
    """B=2, H=16, S=256 (sblk=64 for the S-blocked body, whose TPU kernel
    carries its running max in VMEM scratch across the S grid axis), hb=8,
    row 1 with its last S block masked."""
    mod = tpu['exp_decode_attn_variants']
    monkeypatch.setattr(mod, 'pl', _Interpreted())
    args = _attn_inputs(13)
    jargs = [jnp.asarray(a) for a in args]
    scale = 128 ** -0.5
    targs = [_t(a) for a in args]
    if body == 'floor':
        want = mod.call(mod.k_floor, *jargs, hb=8)
        got = t_attn.floor_reference(*targs)
        step = torch.zeros(())
    elif body == 'mxu':
        want = mod.call(mod.k_mxu, *jargs, hb=8, scale=scale)
        got = int8_decode_attention_reference(*targs)
        step = p8_step(targs[0], targs[1], targs[2], targs[4], targs[5])
    else:
        want = mod.call(mod.k_mxu_sblk, *jargs, hb=8, sblk=64, scale=scale)
        got = t_attn.mxu_sblk_reference(*targs, 64)
        step = t_attn.mxu_sblk_step(*targs, 64)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 16, 1, 128)
    tol = 2 * step.numpy() + TOL * np.abs(want).max()
    err = np.abs(got.numpy() - want)
    assert (err <= tol).all(), f'{body}: max error {err.max():.3e}'
    sblk = 64 if body == 'mxu_sblk' else None
    before = dict(t_attn.probe_decode_attention.launches)
    assert torch.equal(t_attn.probe_decode_attention(*targs, body, 8, sblk),
                       got)
    assert t_attn.probe_decode_attention.launches == before


def test_decode_attn_lstack_plain_matches_the_tpu_call(tpu, monkeypatch):
    """One call for L=2 independent layers (the TPU's ``call_lstack``, q and
    bias shared by the layers) against the stacked plain version."""
    mod = tpu['exp_decode_attn_variants']
    monkeypatch.setattr(mod, 'pl', _Interpreted())
    args = _attn_inputs(14, h=8, s=128, layers=2)
    body = mod._lstack_body(mod.k_mxu, scale=128 ** -0.5)
    q, k8, ks, v8, vs, bias = args
    want = np.asarray(mod.call_lstack(body, *(jnp.asarray(a) for a in
                                             (q, k8, ks, v8, vs, bias)),
                                      hb=8))
    got = t_attn.probe_decode_attention(*(_t(a) for a in args), 'mxu', 8)
    assert got.shape == want.shape == (2, 2, 8, 1, 128)
    for i in range(2):
        step = p8_step(_t(q), _t(k8[i]), _t(ks[i]), _t(vs[i]),
                       _t(bias)).numpy()
        tol = 2 * step + TOL * np.abs(want[i]).max()
        assert (np.abs(got[i].numpy() - want[i]) <= tol).all()


# ------------------------------------------------------ wrappers, entry

def test_probe_wrappers_refuse_other_devices():
    meta = functools.partial(torch.zeros, device='meta')
    with pytest.raises(ValueError, match='unsupported device meta'):
        t_unpack.unpack_matmul(meta((8, 512), dtype=torch.bfloat16),
                               meta((256, 64), dtype=torch.uint8))
    x = meta((8, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='unsupported device meta'):
        t_mm.w8a8_matmul(x, meta((256, 64), dtype=torch.int8), meta((64,)))
    with pytest.raises(ValueError, match='unsupported device meta'):
        t_mm.int4_a8_matmul(x, meta((128, 64), dtype=torch.uint8),
                            meta((1, 64)))
    q = meta((1, 8, 1, 128))
    kv = meta((1, 8, 16, 128), dtype=torch.int8)
    sc = meta((1, 8, 16))
    with pytest.raises(ValueError, match='unsupported device meta'):
        t_attn.probe_decode_attention(q, kv, sc, kv, sc, meta((1, 1, 1, 16)))


@pytest.mark.parametrize('probe', [t_unpack, t_mm, t_attn])
def test_probe_main_refuses_the_cpu_without_device_cpu(monkeypatch, probe):
    """Every probe runs on the card by default; without a CUDA device its
    entry point raises, naming --device cpu."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        probe.main([])


# ------------------------------------------- the card kernels' plans (CPU)

@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('kh,n', [(2048, 512), (5504, 4096), (5568, 4096),
                                  (64, 64)])
def test_int4_unpack_plan_covers_every_packed_row_once(kh, n, sms):
    """#10's launch: #7's decode split of the packed rows (``decode_plan(2
    KH, N, sms)``) where it gives two tiles a split or more, else two,
    whole 64-row tiles, every packed row in exactly one tile of one split,
    the last split shorter where KH asks for it, and two CTAs an SM within
    the shared memory."""
    from groma_tpu_torch.ops.quant4 import decode_plan
    plan = t_unpack.unpack_plan(kh, n, sms)
    rows, splits = decode_plan(2 * kh, n, sms)
    if rows >= 128 or kh < 128:
        assert (plan['split_rows'], plan['splits']) == (rows, splits)
    else:
        assert plan['split_rows'] == 128 and plan['splits'] == -(-kh // 128)
    assert plan['col_tiles'] == -(-n // 128)
    stages = t_unpack.unpack_stages(kh, n, sms)
    assert len(stages) == plan['splits'] and all(stages)
    rows = [r for split in stages for r in split]
    assert all(r % 64 == 0 for r in rows)
    covered = np.zeros(kh, np.int64)
    for r in rows:
        covered[r:r + 64] += 1
    assert (covered == 1).all()
    for z, split in enumerate(stages):
        assert split[0] == z * plan['split_rows']
        assert len(split) * 64 <= plan['split_rows']
        if z < len(stages) - 1:
            assert len(split) >= min(2, kh // 64)
    assert plan['smem'] <= 227 * 1024
    assert 2 * (plan['smem'] + 1024) <= 228 * 1024


def test_int4_unpack_plan_at_down_proj_is_sevens():
    """At down_proj on 132 SMs: 32 column tiles x 8 splits of 11 tiles, the
    last split 9 tiles; a KH of 87 tiles leaves a last split of 10."""
    plan = t_unpack.unpack_plan(5504, 4096, 132)
    assert (plan['col_tiles'], plan['splits'], plan['split_rows']) == (
        32, 8, 704)
    assert [len(s) for s in t_unpack.unpack_stages(5504, 4096, 132)] == \
        [11] * 7 + [9]
    assert [len(s) for s in t_unpack.unpack_stages(5568, 4096, 132)] == \
        [11] * 7 + [10]


@pytest.mark.parametrize('sms', [132, 114, 78])
def test_int4_unpack_plan_at_the_strip_takes_two_tiles_a_split(sms):
    """At the TPU probe's strip (KH=2048, N=512) #7's split gives 32
    one-tile splits; the probe takes 16 of two tiles, 4 column tiles each."""
    plan = t_unpack.unpack_plan(2048, 512, sms)
    assert (plan['col_tiles'], plan['splits'], plan['split_rows']) == (
        4, 16, 128)
    assert [len(s) for s in t_unpack.unpack_stages(2048, 512, sms)] == \
        [2] * 16


@pytest.mark.parametrize('hb', [1, 8])
@pytest.mark.parametrize('sblk', [256, 512, 1000, 1024, 2048, 4096])
@pytest.mark.parametrize('body', ['floor', 'mxu', 'mxu_sblk'])
def test_decode_attn_ring_plan_fits_two_blocks_an_sm(body, sblk, hb):
    """#12's ring: 2 to 4 stages of 64 rows, two scale buffers only where
    heads share a block, and two blocks of it (with the kernel's static
    shared memory and the runtime's 1 KB each) on one SM; every block under
    227 KB up to S = 4096."""
    stages, nbuf = t_attn.ring_plan(body, sblk, hb)
    assert 2 <= stages <= t_attn.MAX_STAGES == 4
    assert nbuf in ((1, 2) if hb > 1 else (1,))
    smem = t_attn.ring_smem(body, sblk, stages, nbuf)
    assert smem <= 227 * 1024
    assert 2 * (smem + t_attn.STATIC_SMEM + 1024) <= t_attn.SM_SMEM
    # the kernel's layout: the ring, nbuf x (ks, vs), and for the mxu
    # bodies the bias, the scores and p8
    pad4 = -(-sblk // 4) * 4
    want = stages * 64 * 128 + nbuf * 8 * pad4
    if body != 'floor':
        want += 8 * pad4 + -(-sblk // 16) * 16
    assert smem == want


@pytest.mark.parametrize('s,sblk,hb', [(1024, None, 1), (1024, None, 8),
                                       (1024, 256, 1), (1024, 256, 32),
                                       (1000, None, 1), (1000, 256, 8),
                                       (1000, 100, 1), (4096, None, 16)])
def test_decode_attn_ring_items_cover_every_position_once(s, sblk, hb):
    """Per S block, the producer's items: for each head in order its K
    stages and then its V stages, each stage 64 rows from the block's
    start (the last shorter), every position of the block in exactly one K
    and one V stage of each head."""
    blocks = t_attn.ring_items(s, sblk or s, hb)
    assert len(blocks) == -(-s // (sblk or s))
    for i, items in enumerate(blocks):
        s0 = i * (sblk or s)
        n = min(s, s0 + (sblk or s)) - s0
        nst = -(-n // 64)
        assert len(items) == 2 * hb * nst
        assert [(h, kv) for h, kv, _, _ in items] == [
            (h, kv) for h in range(hb) for kv in 'kv' for _ in range(nst)]
        for h in range(hb):
            for kv in 'kv':
                mine = [(r, rows) for hh, k, r, rows in items
                        if (hh, k) == (h, kv)]
                assert all((r - s0) % 64 == 0 for r, _ in mine)
                covered = np.zeros(s, np.int64)
                for r, rows in mine:
                    assert 1 <= rows <= 64
                    covered[r:r + rows] += 1
                assert (covered[s0:s0 + n] == 1).all()
                assert covered.sum() == n


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device='meta')


@pytest.mark.parametrize('x,p,variant', [
    ((8, 192), (96, 64), 'A'),        # KH not a multiple of 64
    ((8, 256), (128, 96), 'B'),       # N not a multiple of 64
    ((4, 256), (128, 64), 'C'),       # x not 8 rows
    ((8, 200), (128, 64), 'A'),       # x not 2 KH columns
    ((8, 256), (128, 64), 'D'),       # no such variant
])
def test_unpack_wrapper_refuses_shapes_it_does_not_take(x, p, variant):
    with pytest.raises(ValueError, match='the kernels take'):
        t_unpack.unpack_matmul(_meta(x, torch.bfloat16),
                               _meta(p, torch.uint8), variant)


def test_unpack_wrapper_refuses_other_types():
    with pytest.raises(ValueError, match='the kernels take'):
        t_unpack.unpack_matmul(_meta((8, 256)), _meta((128, 64), torch.uint8))
    with pytest.raises(ValueError, match='the kernels take'):
        t_unpack.unpack_matmul(_meta((8, 256), torch.bfloat16),
                               _meta((128, 64), torch.int8))


@pytest.mark.parametrize('case', ['hb3', 'hb_not_dividing', 'd64', 's_long',
                                  'sblk_long', 'kv_shape', 'bias_shape',
                                  'q_bf16', 'k_uint8', 's_not_4',
                                  'sblk_not_4'])
def test_decode_attn_wrapper_refuses_what_the_kernel_does_not_take(case):
    b, h, s, d = 1, 8, 16, 128
    hb, sblk, body = 1, None, 'mxu'
    q, kv, sc = (b, h, 1, d), (b, h, s, d), (b, h, s)
    bias, qt, kt = (b, 1, 1, s), torch.float32, torch.int8
    if case == 'hb3':
        hb = 3
    elif case == 'hb_not_dividing':
        hb = 16
    elif case == 'd64':
        q, kv = (b, h, 1, 64), (b, h, s, 64)
    elif case == 's_long':
        s = 5000
        kv, sc, bias = (b, h, s, d), (b, h, s), (b, 1, 1, s)
    elif case == 'sblk_long':
        body, sblk = 'mxu_sblk', 5000
    elif case == 's_not_4':        # the scales' bulk copies take 16 bytes
        s = 18
        kv, sc, bias = (b, h, s, d), (b, h, s), (b, 1, 1, s)
    elif case == 'sblk_not_4':
        body, sblk = 'mxu_sblk', 10
    elif case == 'kv_shape':
        kv = (b, h, s + 1, d)
    elif case == 'bias_shape':
        bias = (b, 1, 1, s + 1)
    elif case == 'q_bf16':
        qt = torch.bfloat16
    else:
        kt = torch.uint8
    args = (_meta(q, qt), _meta(kv, kt), _meta(sc), _meta(kv, kt),
            _meta(sc), _meta(bias))
    with pytest.raises(ValueError, match='probe_decode_attention') as e:
        t_attn.probe_decode_attention(*args, body, hb, sblk)
    assert 'unsupported device' not in str(e.value)
