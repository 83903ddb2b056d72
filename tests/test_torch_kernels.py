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
    int8_decode_attention, int8_decode_attention_reference, p8_step)
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
    assert {p.name for p in cuda_lib.CSRC.glob('*.cu')} == {
        'int8_matmul.cu', 'decode_attention.cu'}
