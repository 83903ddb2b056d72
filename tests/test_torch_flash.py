"""The port's flash attention (plain versions, autograd Function, wrapper
contracts) against the JAX package's: its Pallas kernels in interpret mode
and its ``mha_reference``.

Everything is f32, so the kernels' bf16 roundings are no-ops and the sums
differ only in order: tolerance 1e-5 absolute on outputs and lse of unit
scale, 2e-5 on gradients (a few more sums in the chain).  On CPU tensors
the wrappers take the plain versions and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.ops import flash_attention as jfa
from groma_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_attention_bwd_reference, flash_backward,
    flash_bwd_causal, flash_fwd, mha_reference)

torch.set_num_threads(2)
TOL = 1e-5
GRAD_TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, b, h, s, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = skv or s
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    return q, k, v


def _grounded_mask(b, s):
    """Key mask with a mid-sequence gap (unused region slots) per row and a
    ragged padded tail."""
    mask = np.ones((b, s), bool)
    for i in range(b):
        lo = s // 4 + 7 * i
        mask[i, lo:lo + s // 5] = False
        mask[i, s - 13 - 11 * i:] = False
    return mask


def _jax_fwd(q, k, v, mask, causal, block=(64, 128)):
    """The JAX package's forward with its lse, Pallas in interpret mode."""
    out, lse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), causal, q.shape[-1] ** -0.5,
                        block[0], block[1], True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize('s', [200, 77])
def test_causal_forward_and_lse_match_the_tiled_pallas_kernel(s):
    """Causal, ragged S (not a multiple of the blocks), kv mask with
    mid-sequence gaps: packed causal pairs of _fwd_kernel."""
    q, k, v = _inputs(0, 2, 3, s, 32)
    mask = _grounded_mask(2, s)
    want_out, want_lse = _jax_fwd(q, k, v, mask, True)
    out, lse = flash_fwd(_t(q), _t(k), _t(v), _t(mask), True, 32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=TOL)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize('s', [65, 130])
def test_wholekv_forward_matches_the_pallas_kernel(s):
    """Bidirectional: _fwd_wholekv_kernel (S_kv <= 4096 on the TPU)."""
    q, k, v = _inputs(1, 2, 4, s, 64)
    mask = np.ones((2, s), bool)
    mask[1, s // 2:] = False
    want_out, want_lse = _jax_fwd(q, k, v, mask, False)
    out, lse = flash_fwd(_t(q), _t(k), _t(v), _t(mask), False, 64 ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_fully_masked_rows_give_zero_and_lse_neg_inf(causal):
    q, k, v = _inputs(2, 2, 2, 40, 16)
    mask = np.ones((2, 40), bool)
    mask[1] = False                                   # every key masked
    mask[0, :5] = False        # causal: the first 5 queries see no key
    want_out, want_lse = _jax_fwd(q, k, v, mask, causal)
    out, lse = flash_fwd(_t(q), _t(k), _t(v), _t(mask), causal, 16 ** -0.5)
    assert (out[1] == 0).all() and (lse[1] == NEG_INF).all()
    if causal:
        assert (out[0, :, :5] == 0).all() and (lse[0, :, :5] == NEG_INF).all()
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(lse.numpy() == NEG_INF, want_lse <= -1e29)


@pytest.mark.parametrize('causal', [True, False])
def test_gradients_match_jax_grad_of_the_pallas_kernels(causal):
    """dq, dk, dv of the autograd Function (the plain backward from the
    lse recompute) against jax.grad through the Pallas backward kernels
    (the fused causal one, or the two-kernel bidirectional split)."""
    s = 150
    q, k, v = _inputs(3, 2, 2, s, 32)
    mask = _grounded_mask(2, s)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, kv_mask=jnp.asarray(mask),
                                causal=causal, block_q=64, block_k=64,
                                interpret=True)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, _t(mask), causal=causal)
    (out * _t(do)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_backward_matches_autograd_of_the_plain_forward():
    # the plain versions compute in f32: a few f32 roundings apart
    q, k, v = (_t(x) for x in _inputs(5, 1, 2, 33, 8))
    mask = _t(_grounded_mask(1, 33))
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = mha_reference(qq, kk, vv, mask, causal=True)
    do = torch.randn_like(out)
    (out * do).sum().backward()
    got = flash_attention_bwd_reference(q, k, v, mask, out.detach(),
                                        lse.detach(), do, causal=True)
    for g, w in zip(got, (qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    before = (dict(flash_fwd.launches), flash_bwd_causal.launches)
    q, k, v = (_t(x) for x in _inputs(6, 1, 2, 24, 16))
    mask = torch.ones((1, 24), dtype=torch.bool)
    want, lse = mha_reference(q, k, v, mask, True)
    out, got_lse = flash_fwd(q, k, v, mask, True, 0.25)
    assert torch.equal(out, want) and torch.equal(got_lse, lse)
    assert flash_fwd(q, k, v, mask, False, 0.25, need_lse=False)[1] is None
    do = torch.randn_like(q)
    for a, b in zip(flash_bwd_causal(q, k, v, mask, out, lse, do, 0.25),
                    flash_attention_bwd_reference(q, k, v, mask, out, lse,
                                                  do, True, 0.25)):
        assert torch.equal(a, b)
    assert (flash_fwd.launches, flash_bwd_causal.launches) == before


def test_non_causal_backward_is_refused_off_the_cpu():
    """The bidirectional backward (TPU kernel #6) is not ported: any
    non-CPU tensor raises, naming it; the causal one goes to its kernel
    wrapper, which refuses devices other than CUDA."""
    q = torch.zeros((1, 2, 8, 64), device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    lse = torch.zeros((1, 2, 8), device='meta')
    with pytest.raises(NotImplementedError, match='_bwd_dkv_kernel'):
        flash_backward(q, q, q, mask, q, lse, q, False, 0.125)
    with pytest.raises(ValueError, match='unsupported device'):
        flash_backward(q, q, q, mask, q, lse, q, True, 0.125)


@pytest.mark.parametrize('fn', ['wholekv', 'tiled'])
def test_forward_wrappers_refuse_other_devices(fn):
    """Both instantiations: bidirectional (TPU whole-kv) and causal (TPU
    tiled)."""
    q = torch.zeros((1, 2, 8, 64), device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        flash_fwd(q, q, q, mask, fn == 'tiled', 0.125)


def test_forward_keeps_no_lse_without_a_gradient():
    q, k, v = (_t(x) for x in _inputs(7, 1, 1, 16, 8))
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = flash_attention(q.requires_grad_(), k, v, causal=True)
    assert out.grad_fn is not None
