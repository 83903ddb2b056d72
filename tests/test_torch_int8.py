"""The port's int8 matmul: its two tiles' plain versions, plans and
arithmetic on the host, against the JAX package and the plain matmuls.

Tolerances:
* the prefill tile's plain version (``int8_matmul_dense_reference``)
  against JAX's XLA route (``int8_matmul`` at M >= 256 outside interpret
  mode: the weights dequantized to bf16, a bf16 dot with f32 sums, bf16
  out): one bf16 step, 2^-7 x |JAX|, per element (f32 sums in another
  order may round the other way) plus 1e-5 x max|JAX| (where the sums
  cancel), and at least 99 % of the outputs equal;
* the byte conversions of both tiles, emulated bit for bit: exact (the
  decode tile's bf16 of q; the prefill tile's bf16(f32(q) x scale) equal
  to ``dequantize_weight``);
* the plans (``decode_plan``, ``prefill_plan``, ``prefill_tiles``):
  exact coverage of K and of every output tile;
* both tiles' schedules emulated on the host in f32, in the kernels'
  order, against the f32 plain products: rtol and atol 1e-5 (the same sums
  in another order).
On CPU tensors the wrapper takes ``int8_matmul_reference`` at every M and
launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.ops.quant import int8_matmul as j_int8_matmul
from groma_tpu.ops.quant import quantize_weight as j_quantize_weight
from groma_tpu_torch.ops.quant import (DECODE_CTAS_PER_SM, DECODE_ROWS,
                                       DECODE_TILE, DENSE_MIN_ROWS,
                                       PREFILL_STAGE_ROWS, PREFILL_TILE,
                                       decode_plan, dequantize_weight,
                                       int8_matmul,
                                       int8_matmul_dense_reference,
                                       int8_matmul_reference, prefill_plan,
                                       prefill_tiles, quantize_weight)

torch.set_num_threads(2)

# (K, N) of the int8 tree's matmuls at 7B width (chip_smoke's shapes), the
# ragged head as the wrapper pads it, and a small one
_PLAN_SHAPES = {'qkv_proj': (4096, 12288), 'o_proj': (4096, 4096),
                'gate_up_proj': (4096, 22016), 'down_proj': (11008, 4096),
                'lm_head': (4096, 32256), 'lm_head ragged, padded':
                (4096, 32128), 'small': (320, 208)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(a):
    """f32 numpy -> the nearest bf16 values, as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_bits(b):
    """uint32 bf16 bit patterns -> their values, as f32."""
    return (b << 16).astype(np.uint32).view(np.float32)


def _decode_bytes(q):
    """The decode tile's bf16 of each int8: (128 + its low 7 bits) less
    (128, or 256 where the sign bit is set)."""
    u = q.view(np.uint8).astype(np.uint32)
    return _bf16_bits(0x4300 | (u & 0x7F)) - _bf16_bits(0x4300 | (u & 0x80))


def _prefill_bytes(q):
    """The prefill tile's f32 of each int8: q + 128 in the mantissa of
    2^23, less 2^23 + 128."""
    u = q.view(np.uint8).astype(np.uint32)
    return ((u ^ 0x80) | 0x4B000000).astype(np.uint32).view(np.float32) \
        - np.float32(8388736.0)


def _weights(rng, k, n):
    """int8 weights of a trained layer's scale, N(0, 1/K): outputs of
    order 1."""
    q, s = quantize_weight(_t(rng.standard_normal((k, n)) / np.sqrt(k)))
    return q.numpy(), s.numpy()


@pytest.mark.parametrize('m', [256, 300])
@pytest.mark.parametrize('k', [64, 96])
def test_dense_reference_matches_jax_xla_route(rng, m, k):
    n = 200
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, scale = j_quantize_weight(
        jnp.asarray(rng.standard_normal((k, n)), jnp.float32))
    want = np.asarray(j_int8_matmul(jnp.asarray(x, jnp.bfloat16), wq, scale,
                                    interpret=False), np.float32)
    got = int8_matmul_dense_reference(_t(x), _t(wq), _t(scale))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()
    assert (got == want).mean() >= 0.99


def test_byte_conversions_are_exact(rng):
    """Every int8 through the decode tile's bf16 pair (the low 7 bits over
    128, less 128 or 256 by the sign bit) and through the prefill tile's
    dequantization (the byte in the mantissa of 2^23, less 2^23 + 128,
    times the scale in f32, rounded to bf16)."""
    q = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(_decode_bytes(q), q.astype(np.float32))
    f = _prefill_bytes(q)
    np.testing.assert_array_equal(f, q.astype(np.float32))
    scales = np.concatenate([
        np.float32([1.0, 2.0 ** -7, 1e-3 / 127]),
        (np.abs(rng.standard_normal(61)) * 1e-2).astype(np.float32)])
    for s in scales:
        got = _bf16(f * np.float32(s))          # __fmul_rn, cvt.rn.bf16
        want = dequantize_weight(_t(q[:, None]), _t(np.float32([s])))
        np.testing.assert_array_equal(got, want.float().numpy()[:, 0])


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('m', [1, 8, 100])
@pytest.mark.parametrize('shape', list(_PLAN_SHAPES))
def test_decode_plan_covers_k_once(shape, m, sms):
    """The decode tile's split of K: whole 128-row boxes, every k row in
    exactly one split, no split empty, at most one wave of CTAs where K is
    split, and at least one CTA per SM where the shape has that many
    boxes."""
    k, n = _PLAN_SHAPES[shape]
    rows, cols = DECODE_TILE
    split_rows, splits = decode_plan(m, k, n, sms)
    assert split_rows % rows == 0 and split_rows > 0
    seen = np.zeros(k, dtype=int)
    for s in range(splits):
        lo, hi = s * split_rows, min((s + 1) * split_rows, k)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    blocks = -(-n // cols) * -(-m // DECODE_ROWS)
    assert blocks * splits >= min(sms, blocks * -(-k // rows))
    assert splits == 1 or blocks * splits <= DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize('m', [256, 300, 2048])
@pytest.mark.parametrize('shape', list(_PLAN_SHAPES))
def test_prefill_plan_covers_every_tile_once(shape, m):
    """The prefill tile's persistent grid: every (token tile, column tile)
    in exactly one CTA, no CTA idle, at most one CTA per SM, the CTAs in
    flight on few column tiles (tokens fastest)."""
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


@pytest.mark.parametrize('m,k,n', [(1, 320, 208), (8, 1408, 400),
                                   (20, 256, 144)])
def test_decode_schedule_computes_the_matmul(rng, m, k, n):
    """The decode tile's arithmetic in its own order on the host: per
    (column tile, 8-row chunk, split), per 128-row box (k past K, rows past
    M and columns past N zero, as TMA fills them), per 64-row tile, warp ks
    sums its k16 step's products of x and the bytes as the tile converts
    them; the four warps are summed in order, then the splits in order,
    then scaled; equal to the plain matmul."""
    x = _bf16(rng.standard_normal((m, k)))
    wq, scale = _weights(rng, k, n)
    rows, cols = DECODE_TILE
    split_rows, splits = decode_plan(m, k, n, 7)
    col_tiles, chunks = -(-n // cols), -(-m // DECODE_ROWS)
    kk = splits * split_rows
    wf = np.zeros((kk, col_tiles * cols), np.float32)
    wf[:k, :n] = _decode_bytes(wq)
    xp = np.zeros((chunks * DECODE_ROWS, kk), np.float32)
    xp[:m, :k] = x
    out = np.full((m, n), np.nan, np.float32)
    for z in range(chunks):
        xs = xp[z * DECODE_ROWS:(z + 1) * DECODE_ROWS]
        for c in range(col_tiles):
            cs = slice(c * cols, (c + 1) * cols)
            total = np.zeros((DECODE_ROWS, cols), np.float32)
            for sp in range(splits):
                part = np.zeros((4, DECODE_ROWS, cols), np.float32)
                for r in range(sp * split_rows, (sp + 1) * split_rows, rows):
                    for r64 in range(r, r + rows, 64):
                        for ks in range(4):
                            ksl = slice(r64 + 16 * ks, r64 + 16 * ks + 16)
                            part[ks] += xs[:, ksl] @ wf[ksl, cs]
                total += ((part[0] + part[1]) + part[2]) + part[3]
            keep = min(DECODE_ROWS, m - z * DECODE_ROWS), min(cols,
                                                              n - c * cols)
            out[z * DECODE_ROWS:z * DECODE_ROWS + keep[0],
                c * cols:c * cols + keep[1]] = \
                (total * np.pad(scale, (0, col_tiles * cols - n))[cs])[
                    :keep[0], :keep[1]]
    want = int8_matmul_reference(_t(x), _t(wq), _t(scale)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('m,k,n', [(256, 192, 144), (300, 128, 400),
                                   (600, 320, 272)])
def test_prefill_schedule_computes_the_matmul(rng, m, k, n):
    """The prefill tile's arithmetic in its own order on the host: its A
    operand as the tile converts the bytes (bitwise ``dequantize_weight``),
    per output tile of its CTA (rows past M, k past K and columns past N
    zero, as TMA fills them), per 64-row stage the product of x and A with
    f32 sums; every output tile written once, equal to the f32 product of
    x in bf16 and the dequantized weights."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, scale = _weights(rng, k, n)
    a = _bf16(_prefill_bytes(wq) * scale[None, :])
    np.testing.assert_array_equal(
        a, dequantize_weight(_t(wq), _t(scale)).float().numpy())
    tok, cols = PREFILL_TILE
    rows = PREFILL_STAGE_ROWS
    ctas, tok_tiles, col_tiles = prefill_plan(m, n, 7)
    kk = -(-k // rows) * rows
    ap = np.zeros((kk, col_tiles * cols), np.float32)
    ap[:k, :n] = a
    xp = np.zeros((tok_tiles * tok, kk), np.float32)
    xp[:m, :k] = _bf16(x)
    out = np.full((m, n), np.nan, np.float32)
    written = np.zeros((m, n), int)
    for tiles in prefill_tiles(m, n, 7):
        for t, c in tiles:
            xs, cs = slice(t * tok, (t + 1) * tok), slice(c * cols,
                                                         (c + 1) * cols)
            acc = np.zeros((tok, cols), np.float32)
            for k0 in range(0, kk, rows):
                acc += xp[xs, k0:k0 + rows] @ ap[k0:k0 + rows, cs]
            keep = min(tok, m - t * tok), min(cols, n - c * cols)
            if keep[1] > 0:
                out[t * tok:t * tok + keep[0],
                    c * cols:c * cols + keep[1]] = acc[:keep[0], :keep[1]]
                written[t * tok:t * tok + keep[0],
                        c * cols:c * cols + keep[1]] += 1
    assert (written == 1).all()
    want = _bf16(x) @ a
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    # the tile's bf16 output is the dense plain version's, up to one bf16
    # step where the f32 sums round the other way (or cancel)
    ref = int8_matmul_dense_reference(_t(x), _t(wq), _t(scale)).float()
    ref = ref.numpy()
    tol = 2.0 ** -7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert (np.abs(_bf16(out) - ref) <= tol).all()


@pytest.mark.parametrize('m', [3, DENSE_MIN_ROWS, 300])
def test_cpu_wrapper_takes_the_decode_reference_at_every_m(rng, m):
    """On CPU tensors the wrapper is ``int8_matmul_reference`` at every M
    (JAX in interpret mode runs the kernel body at every M) and launches
    no tile; other devices are refused on both routes."""
    before = (int8_matmul.launches, int8_matmul.prefill_launches)
    x = _t(rng.standard_normal((m, 64)).astype(np.float32))
    wq, scale = quantize_weight(_t(rng.standard_normal((64, 48))))
    assert torch.equal(int8_matmul(x, wq, scale),
                       int8_matmul_reference(x, wq, scale))
    assert (int8_matmul.launches, int8_matmul.prefill_launches) == before
    with pytest.raises(ValueError):
        int8_matmul(torch.zeros((m, 64), dtype=torch.bfloat16,
                                device='meta'),
                    torch.zeros((64, 48), dtype=torch.int8, device='meta'),
                    torch.zeros(48, device='meta'))
