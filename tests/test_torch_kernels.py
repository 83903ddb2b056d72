"""The plain versions of the port's two CUDA kernels against the JAX
package: the Pallas kernel bodies run in interpret mode, and the XLA
paths they replace.  On CPU tensors the wrappers take the plain versions
and launch nothing.

Tolerances:
* int8 matmul: 1e-5 x max|out| (f32 sums in another order; the int8
  products themselves are exact);
* decode attention: two p8 units per (b, h) row (``p8_step``), plus 1e-5:
  the f32 exp of XLA and of torch may differ in the last bit, and a
  requantized probability on a .5 tie may then round the other way;
* the card kernel's cluster schedule emulated in torch (kept slots only,
  64-slot chunks round-robin over C CTAs, the global max, partial sums in
  rank order): p8 bitwise the plain version's, the output within 1e-5
  relative (the denominator's f32 sum in another order);
* quantized weights: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_llama
from groma_tpu.config import LlamaConfig
from groma_tpu.models.llama_quant import (
    _int8_cache_attention as j_cache_attention,
    _quantize_tokens as j_quantize_tokens,
    quantize_llama_params as j_quantize_llama)
from groma_tpu.ops.decode_attention import _call_kernel
from groma_tpu.ops.quant import int8_matmul as j_int8_matmul
from groma_tpu.ops.quant import quantize_weight as j_quantize_weight
from groma_tpu_torch.models.llama_quant import (
    _int8_cache_attention as t_cache_attention,
    _quantize_tokens as t_quantize_tokens,
    quantize_llama_params as t_quantize_llama)
from groma_tpu_torch.ops.decode_attention import (
    CHUNK_ROWS, PLAN_CLUSTER, SMEM_PER_SM, STATIC_SMEM, _requantized_probs,
    decode_attention_plan, decode_attention_smem, int8_decode_attention,
    int8_decode_attention_reference, kept_slots, p8_step, rank_chunks)
from groma_tpu_torch.ops.quant import (int8_matmul, int8_matmul_reference,
                                       quantize_weight)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('pad_to', [0, 64])
def test_quantize_weight_matches_jax(rng, pad_to):
    w = rng.standard_normal((96, 150)).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    jq, js = j_quantize_weight(jnp.asarray(w), pad_to=pad_to)
    tq, ts = quantize_weight(_t(w), pad_to=pad_to)
    assert tq.dtype == torch.int8 and tq.shape == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('m', [1, 3, 8, 20])
@pytest.mark.parametrize('k', [64, 40])          # 40: JAX's XLA fallback
def test_int8_matmul_reference_matches_jax(rng, m, k):
    n = 200
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, scale = j_quantize_weight(
        jnp.asarray(rng.standard_normal((k, n)), jnp.float32))
    want = np.asarray(j_int8_matmul(jnp.asarray(x), wq, scale,
                                    interpret=True))
    got = int8_matmul_reference(_t(x), _t(wq), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _attention_inputs(rng, b, h, s, d, masked_tail):
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k8, ks = j_quantize_tokens(jnp.asarray(
        rng.standard_normal((b, h, s, d)), jnp.float32))
    v8, vs = j_quantize_tokens(jnp.asarray(
        rng.standard_normal((b, h, s, d)), jnp.float32))
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[..., s - masked_tail:] = -1e30
    return [np.asarray(a) for a in (q, k8, ks, v8, vs, bias)]


def _assert_within_p8_units(got, want, args):
    step = p8_step(*[_t(a) for a in (args[0], args[1], args[2], args[4],
                                     args[5])]).numpy()
    tol = 2 * step + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), \
        f'max error {(np.abs(got - want) / step).max():.2f} p8 units'


def test_decode_attention_reference_matches_pallas_kernel(rng):
    args = _attention_inputs(rng, b=2, h=8, s=256, d=128, masked_tail=32)
    want = np.asarray(_call_kernel(*[jnp.asarray(a) for a in args],
                                   interpret=True))
    got = int8_decode_attention_reference(*[_t(a) for a in args]).numpy()
    assert got.shape == want.shape == (2, 8, 1, 128)
    _assert_within_p8_units(got, want, args)


def test_decode_attention_reference_matches_xla_chain_ragged_s(rng):
    """S = 200 (not a multiple of 128: the TPU wrapper would fall back to
    this XLA chain) with a fully masked tail."""
    args = _attention_inputs(rng, b=2, h=4, s=200, d=128, masked_tail=56)
    want = np.asarray(j_cache_attention(*[jnp.asarray(a) for a in args]))
    got = int8_decode_attention_reference(*[_t(a) for a in args]).numpy()
    assert np.isfinite(got).all()
    _assert_within_p8_units(got, want, args)
    # the port's own copy of the XLA chain
    mine = t_cache_attention(*[_t(a) for a in args]).numpy()
    _assert_within_p8_units(mine, want, args)


def test_quantize_tokens_matches_jax(rng):
    x = rng.standard_normal((2, 3, 17, 128)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = j_quantize_tokens(jnp.asarray(x))
    tq, ts = t_quantize_tokens(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_llama_params_matches_jax(rng):
    cfg = LlamaConfig(vocab_size=300, hidden_size=64, intermediate_size=96,
                      num_layers=2, num_heads=4, num_kv_heads=4,
                      dtype='float32')

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    model = {'norm': {'scale': w(64)}}
    for i in range(cfg.num_layers):
        model[f'layers_{i}'] = {
            'input_layernorm': {'scale': w(64)},
            'post_attention_layernorm': {'scale': w(64)},
            'self_attn': {p: {'kernel': w(64, 64)}
                          for p in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            'gate_proj': {'kernel': w(64, 96)},
            'up_proj': {'kernel': w(64, 96)},
            'down_proj': {'kernel': w(96, 64)},
        }
    params = {'model': model, 'embed_tokens': w(300, 64),
              'lm_head': {'kernel': w(64, 300)}}
    want = j_quantize_llama(params, cfg, bits=8)
    sd = {k: _t(v) for k, v in export_llama(params, cfg.num_layers).items()}
    got = t_quantize_llama(sd, cfg, bits=8)

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
    assert got['lm_head']['q'].shape == (64, 512)    # padded to 512
    # the CUDA kernel reads the int8 weights row-major
    assert all(t.is_contiguous() for t in jax.tree_util.tree_leaves(
        got, is_leaf=torch.is_tensor))


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing(rng):
    before = (int8_matmul.launches, int8_decode_attention.launches)
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    wq, scale = quantize_weight(_t(rng.standard_normal((64, 48))))
    assert torch.equal(int8_matmul(x, wq, scale),
                       int8_matmul_reference(x, wq, scale))
    args = [_t(a) for a in _attention_inputs(rng, 1, 2, 40, 128, 8)]
    assert torch.equal(int8_decode_attention(*args),
                       int8_decode_attention_reference(*args))
    assert (int8_matmul.launches, int8_decode_attention.launches) == before


def test_wrappers_refuse_other_devices(rng):
    x = torch.zeros((2, 64), device='meta')
    wq = torch.zeros((64, 48), dtype=torch.int8, device='meta')
    with pytest.raises(ValueError):
        int8_matmul(x, wq, torch.zeros(48, device='meta'))
    with pytest.raises(ValueError):
        int8_decode_attention(*[torch.zeros(s, device='meta') for s in (
            (1, 2, 1, 128), (1, 2, 8, 128), (1, 2, 8), (1, 2, 8, 128),
            (1, 2, 8), (1, 1, 1, 8))])


def test_kernel_library_is_built_only_at_first_launch():
    from groma_tpu_torch.ops import cuda_lib
    assert cuda_lib._lib is None       # nothing above launched a kernel
    assert {p.name for p in cuda_lib.sources()} == {
        'int8_matmul.cu', 'decode_attention.cu', 'flash_attention_fwd.cu',
        'flash_attention_bwd.cu', 'int4_matmul.cu', 'paged_attention.cu',
        'decode_megakernel.cu'}


def test_probe_library_holds_the_probes_alone():
    """The probes build into their own library, which only the probes'
    entry points load: a probe's compile error leaves the production
    library whole."""
    from groma_tpu_torch.ops import cuda_lib
    assert cuda_lib._probe_lib is None
    assert {p.name for p in cuda_lib.probe_sources()} == {
        'probe_int4_unpack.cu', 'probe_decode_matmul_m8.cu',
        'probe_decode_attn.cu'}
    assert not set(cuda_lib.sources()) & set(cuda_lib.probe_sources())
    assert {p.name for p in cuda_lib.CSRC.glob('*.cu')} == {
        p.name for p in cuda_lib.sources() + cuda_lib.probe_sources()}


def _cluster_schedule(q, k8, ks, v8, vs, bias, c):
    """The card kernel's schedule for each (b, h), in its order: the kept
    list, its 64-slot chunks round-robin over the c CTAs, each CTA's scores
    and max, the global max, p against it, the CTAs' partial denominators
    added in rank order, r the max of their maxima of ps, p8 per CTA, the
    exact int32 p . v partials added by rank 0.  -> (out, p8 over S)."""
    b, h, _, d = q.shape
    s_len = k8.shape[2]
    qf = q[:, :, 0].to(torch.float32)
    amax = qf.abs().amax(-1, keepdim=True)
    qs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q8 = torch.round(qf / qs)
    out = torch.zeros((b, h, 1, d))
    p8_all = torch.zeros((b, h, s_len))
    for bi in range(b):
        slots = kept_slots(bias[bi, 0, 0])
        ranks = [torch.cat([torch.arange(lo, hi) for lo, hi in chunks])
                 if chunks else torch.zeros(0, dtype=torch.long)
                 for chunks in rank_chunks(len(slots), c)]
        for hi_ in range(h):
            pos = [slots[r] for r in ranks]
            dots = [(k8[bi, hi_, p_].double() @ q8[bi, hi_].double()).float()
                    for p_ in pos]
            scores = [dt * (qs[bi, hi_] * d ** -0.5) * ks[bi, hi_, p_]
                      + bias[bi, 0, 0, p_] for dt, p_ in zip(dots, pos)]
            m = max(sc.max() if len(sc) else torch.tensor(-float('inf'))
                    for sc in scores)
            ps, denom, r = [], torch.tensor(0.0), torch.tensor(0.0)
            for sc, p_ in zip(scores, pos):
                p = torch.exp(sc - m)
                denom = denom + p.sum()
                ps.append(p * vs[bi, hi_, p_])
                if len(p_):
                    r = torch.maximum(r, ps[-1].max())
            r = r / 127.0 if r > 0 else torch.tensor(1.0)
            o = torch.zeros(d, dtype=torch.float64)
            for pr, p_ in zip(ps, pos):
                p8 = torch.round(pr / r)
                p8_all[bi, hi_, p_] = p8
                o += p8.double() @ v8[bi, hi_, p_].double()
            out[bi, hi_, 0] = o.float() * (r / torch.clamp(denom, min=1e-30))
    return out, p8_all


def _served_like_bias(s, rows):
    """(len(rows), 1, 1, s): per row a list of kept [lo, hi) ranges, the
    rest -1e30 (the served stream: template blocks, then the decoded
    tail)."""
    bias = np.full((len(rows), 1, 1, s), -1e30, np.float32)
    for i, ranges in enumerate(rows):
        for lo, hi in ranges:
            bias[i, ..., lo:hi] = 0.0
    return bias


@pytest.mark.parametrize('c', [1, 2, 3, 4])
def test_decode_attention_cluster_schedule_matches_plain(rng, c):
    """Served-like masks, a row with no kept slot (uniform p over all S), a
    row whose only kept slot is its last, and S = 300, not a multiple of
    64 C."""
    s = 300
    args = _attention_inputs(rng, b=4, h=2, s=s, d=128, masked_tail=0)
    args[-1] = _served_like_bias(s, [
        [(0, 7), (7, 71), (71, 121), (121, 140), (256, 270)],
        [], [(s - 1, s)], [(3, 5), (64, 200), (299, 300)]])
    targs = [_t(a) for a in args]
    want = int8_decode_attention_reference(*targs)
    want_p8 = _requantized_probs(*targs[:3], targs[4], targs[5])[0]
    got, got_p8 = _cluster_schedule(*targs, c)
    assert torch.equal(got_p8, want_p8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    # the all-masked row is the uniform average of its values, not 0
    assert want[1].abs().max() > 0


def test_masked_slot_p_is_exactly_zero(rng):
    """Under the contract's bias (0 or -1e30), with one slot kept, every
    masked slot's p = exp(s - m) is exactly 0, even with the largest int8
    scores, so the kernel may skip it."""
    args = _attention_inputs(rng, b=2, h=4, s=256, d=128, masked_tail=0)
    args[0] = np.full_like(args[0], 1e4)                # q8 all 127
    args[1] = np.full_like(args[1], 127)
    args[2] = np.full_like(args[2], 1e3)                # large k scales
    args[-1] = _served_like_bias(256, [[(5, 6)], [(0, 100), (200, 256)]])
    q, k8, ks, v8, vs, bias = [_t(a) for a in args]
    qf = q[:, :, 0]
    qs = qf.abs().amax(-1, keepdim=True) / 127.0
    s = torch.einsum('bhd,bhsd->bhs', torch.round(qf / qs).double(),
                     k8.double()).float()
    s = s * (qs * 128 ** -0.5) * ks + bias[:, 0]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    masked = (bias[:, 0] < -1e29).expand_as(p)
    assert s.abs()[~masked].max() > 1e6                  # scores far from 0
    assert (p[masked] == 0).all()
    assert (_requantized_probs(q, k8, ks, vs, bias)[0][masked] == 0).all()


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('b,s', [(1, 2112), (4, 2112), (8, 1024), (8, 2112),
                                 (1, 4096), (8, 4096), (32, 1024)])
def test_decode_attention_plan_covers_the_list_once(b, s, sms):
    """At the 7B shapes (H = 32): a cluster of 1..PLAN_CLUSTER CTAs, a ring
    of 2, 4 or 8 stages that lets two CTAs share an SM, and for any count
    of kept slots every list position read by exactly one CTA."""
    c, stages = decode_attention_plan(b, 32, s, sms)
    assert 1 <= c <= PLAN_CLUSTER and stages in (2, 4, 8)
    assert 2 * (decode_attention_smem(s, stages) + STATIC_SMEM) \
        <= SMEM_PER_SM
    if b * 32 * PLAN_CLUSTER <= 2 * sms:
        assert c == PLAN_CLUSTER  # the served B=1 spreads over clusters
    for n in (1, CHUNK_ROWS - 1, CHUNK_ROWS, CHUNK_ROWS + 1, 572, s):
        seen = sorted(i for chunks in rank_chunks(n, c)
                      for lo, hi in chunks for i in range(lo, hi))
        assert seen == list(range(n))


def test_kept_slots_follow_the_contract():
    bias = torch.tensor([0.0, -1e30, -5.0, -1e30, 0.0])
    assert kept_slots(bias).tolist() == [0, 2, 4]     # any finite bias kept
    assert kept_slots(torch.full((4,), -1e30)).tolist() == [0, 1, 2, 3]
