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
    NEG_INF, flash_attention, flash_attention_bwd_reference, flash_bwd,
    flash_fwd, mha_reference)
from groma_tpu_torch.ops import flash_attention as tfa

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


@pytest.mark.parametrize('causal,sq,skv,dead_row', [
    pytest.param(True, 150, 150, False, id='True'),
    pytest.param(False, 150, 150, False, id='False'),
    pytest.param(False, 100, 130, True, id='False-sq100-skv130-dead_row')])
def test_gradients_match_jax_grad_of_the_pallas_kernels(causal, sq, skv,
                                                        dead_row):
    """dq, dk, dv of the autograd Function (the plain backward from the
    lse recompute) against jax.grad through the Pallas backward kernels
    (the fused causal one, or the two-kernel bidirectional split
    _bwd_dkv_kernel + _bwd_dq_kernel), under a key mask with gaps and a
    masked tail; bidirectional also at Sq != Skv (a padded query tail tile)
    with batch row 1 fully masked, whose gradients must be exactly 0."""
    q, k, v = _inputs(3, 2, 2, sq, 32, skv)
    mask = _grounded_mask(2, skv)
    if dead_row:
        mask[1] = False
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
        if dead_row:
            assert (got[1] == 0).all() and (np.asarray(w)[1] == 0).all()


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
    before = (dict(flash_fwd.launches), dict(flash_bwd.launches))
    q, k, v = (_t(x) for x in _inputs(6, 1, 2, 24, 16))
    mask = torch.ones((1, 24), dtype=torch.bool)
    want, lse = mha_reference(q, k, v, mask, True)
    out, got_lse = flash_fwd(q, k, v, mask, True, 0.25)
    assert torch.equal(out, want) and torch.equal(got_lse, lse)
    assert flash_fwd(q, k, v, mask, False, 0.25, need_lse=False)[1] is None
    do = torch.randn_like(q)
    for causal in (True, False):
        for a, b in zip(flash_bwd(q, k, v, mask, out, lse, do, causal, 0.25),
                        flash_attention_bwd_reference(q, k, v, mask, out, lse,
                                                      do, causal, 0.25)):
            assert torch.equal(a, b)
    assert (flash_fwd.launches, flash_bwd.launches) == before


def test_non_causal_backward_goes_to_its_kernel_wrapper(monkeypatch):
    """Both masks' backward (the bidirectional one is TPU kernel #6) go
    from ``flash_attention``'s autograd to the kernel wrapper ``flash_bwd``
    with the forward's mask flag; it refuses devices other than CUDA,
    naming the device, and launches nothing."""
    q = torch.zeros((1, 2, 8, 64), device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    lse = torch.zeros((1, 2, 8), device='meta')
    before = dict(flash_bwd.launches)
    for causal in (False, True):
        with pytest.raises(ValueError,
                           match='flash_bwd: unsupported device meta'):
            flash_bwd(q, q, q, mask, q, lse, q, causal, 0.125)
    assert flash_bwd.launches == before

    seen = []

    def spy(*args):
        seen.append(args[7])
        return flash_bwd(*args)

    monkeypatch.setattr(tfa, 'flash_bwd', spy)
    x = _t(_inputs(3, 1, 2, 8, 16)[0]).requires_grad_()
    for causal in (False, True):
        flash_attention(x, x, x, causal=causal).sum().backward()
    assert seen == [False, True]


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


@pytest.mark.parametrize('causal,sq,skv,dead_row', [
    pytest.param(True, 129, 129, False, id='causal-S129'),
    pytest.param(False, 65, 193, True, id='bidirectional-sq65-skv193-dead')])
def test_plain_backward_at_the_hopper_tile_edges(causal, sq, skv, dead_row):
    """The backward the card's kernel must reproduce, at the edges of its
    tiles (64 queries a step, 128 keys a CTA): causal S = 129, one row past
    a 128-key tile; bidirectional 65 queries (one past a query tile) over
    193 keys (one key tile and a ragged one) with batch row 1 fully masked.
    ``flash_bwd``'s plain version from the port's forward against jax.grad
    through the Pallas backward kernels in interpret mode."""
    q, k, v = _inputs(8, 2, 2, sq, 64, skv)
    mask = _grounded_mask(2, skv)
    if dead_row:
        mask[1] = False
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, kv_mask=jnp.asarray(mask),
                                causal=causal, block_q=64, block_k=64,
                                interpret=True)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tmask = _t(q), _t(k), _t(v), _t(mask)
    out, lse = flash_fwd(tq, tk, tv, tmask, causal, 64 ** -0.5)
    got = flash_bwd(tq, tk, tv, tmask, out, lse, _t(do), causal, 64 ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
        if dead_row:
            assert (g[1] == 0).all() and (np.asarray(w)[1] == 0).all()


@pytest.mark.parametrize('what,d,dtype,lse_shape,match', [
    ('head dim 32', 32, torch.bfloat16, (1, 2, 8), r'D in \(64, 128\)'),
    ('head dim 256', 256, torch.bfloat16, (1, 2, 8), r'D in \(64, 128\)'),
    ('f16', 64, torch.float16, (1, 2, 8), 'the kernel takes bf16'),
    ('lse (B, H)', 64, torch.bfloat16, (1, 2), 'lse be'),
    ('lse (B, H, Sq, 1)', 64, torch.bfloat16, (1, 2, 8, 1), 'lse be')])
def test_backward_wrapper_refuses_what_its_kernel_does_not_take(
        monkeypatch, what, d, dtype, lse_shape, match):
    """On meta tensors (no data, no card) ``flash_bwd`` names the head dim
    outside (64, 128), a dtype other than bf16 or a malformed lse, raises
    ValueError, launches nothing and never asks for the kernel library."""
    from groma_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError('the kernel library was asked for')
    monkeypatch.setattr(cuda_lib, 'library', no_build)
    q = torch.zeros((1, 2, 8, d), dtype=dtype, device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    lse = torch.zeros(lse_shape, device='meta')
    before = dict(flash_bwd.launches)
    for causal in (False, True):
        with pytest.raises(ValueError, match=match):
            flash_bwd(q, q, q, mask, q, lse, q, causal, d ** -0.5)
    assert flash_bwd.launches == before
    assert cuda_lib._lib is None


@pytest.mark.parametrize('what,d,dtype,match', [
    ('head dim 32', 32, torch.bfloat16, r'D in \(64, 128\)'),
    ('head dim 256', 256, torch.bfloat16, r'D in \(64, 128\)'),
    ('f16', 64, torch.float16, 'the kernel takes bf16')])
def test_forward_wrapper_refuses_what_its_kernel_does_not_take(
        monkeypatch, what, d, dtype, match):
    """On meta tensors (no data, no card) ``flash_fwd`` names the head dim
    outside (64, 128) or a dtype other than bf16, for both masks, raises
    ValueError, launches nothing and never asks for the kernel library."""
    from groma_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError('the kernel library was asked for')
    monkeypatch.setattr(cuda_lib, 'library', no_build)
    q = torch.zeros((1, 2, 8, d), dtype=dtype, device='meta')
    mask = torch.ones((1, 8), dtype=torch.bool, device='meta')
    before = dict(flash_fwd.launches)
    for causal in (False, True):
        for need_lse in (True, False):
            with pytest.raises(ValueError, match=match):
                flash_fwd(q, q, q, mask, causal, d ** -0.5, need_lse)
    assert flash_fwd.launches == before
    assert cuda_lib._lib is None


@pytest.mark.parametrize('causal,sq,skv,d,dead_row', [
    pytest.param(True, 129, 129, 128, False, id='causal-S129-D128'),
    pytest.param(False, 129, 193, 64, True,
                 id='bidirectional-sq129-skv193-D64-dead'),
    pytest.param(True, 100, 130, 64, False, id='causal-sq100-skv130')])
def test_plain_forward_at_the_hopper_tile_edges(causal, sq, skv, d,
                                                dead_row):
    """The forward the card's kernel must reproduce, at the edges of its
    tiles (128 query rows and 128 keys a tile at D = 128; 64 and 64 at
    D = 64): causal S = 129, one row past a query tile and a key tile;
    bidirectional 129 queries over 193 keys with batch row 1 fully masked
    (out exactly 0, lse exactly -1e30); causal 100 queries over 130 keys,
    the band's offset Skv - Sq = 30.  ``flash_fwd``'s plain version
    against the Pallas kernels in interpret mode, out and lse."""
    q, k, v = _inputs(10, 2, 2, sq, d, skv)
    mask = _grounded_mask(2, skv)
    if dead_row:
        mask[1] = False
    want_out, want_lse = _jax_fwd(q, k, v, mask, causal)
    out, lse = flash_fwd(_t(q), _t(k), _t(v), _t(mask), causal, d ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=TOL)
    if dead_row:
        assert (out[1] == 0).all() and (lse[1] == NEG_INF).all()
        assert (want_out[1] == 0).all() and (want_lse[1] <= -1e29).all()
