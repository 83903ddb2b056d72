"""#1's and #7's host-side plans and arithmetic at the GQA width of the
fused qkv: 32 query heads and 8 KV heads of 128 at hidden 4096 give
N = 4096 + 2 x 1024 = 6144 columns (the 7B shapes, N = 12288 and the
rest, are held in ``tests/test_torch_int8.py`` and
``tests/test_torch_quant4.py``).

Both kernels take N = 6144 as they stand: it is a whole number of their
128-column tiles.  Here, for 132, 114 and 78 SMs: every k row in one split
and every output tile in one CTA of each plan; the int4 stages inside one
scale block and nibble half; and each tile's schedule emulated in f32 in
the kernel's order at (K, N) = (4096, 6144) equal to the plain version
within 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from groma_tpu_torch.ops import quant, quant4

K, N = 4096, 4096 + 2 * 8 * 128
SMS = (132, 114, 78)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_bits(b):
    return (b << 16).astype(np.uint32).view(np.float32)


def _decode_bytes(q):
    """The int8 decode tile's bf16 of each byte (tests/test_torch_int8.py)."""
    u = q.view(np.uint8).astype(np.uint32)
    return _bf16_bits(0x4300 | (u & 0x7F)) - _bf16_bits(0x4300 | (u & 0x80))


def _prefill_bytes(q):
    """The int8 prefill tile's f32 of each byte."""
    u = q.view(np.uint8).astype(np.uint32)
    return ((u ^ 0x80) | 0x4B000000).astype(np.uint32).view(np.float32) \
        - np.float32(8388736.0)


@pytest.fixture(scope='module')
def int8_weights():
    rng = np.random.default_rng(0)
    q, s = quant.quantize_weight(_t(rng.standard_normal((K, N)).astype(
        np.float32) / np.sqrt(K)))
    return q.numpy(), s.numpy()


def _tiles_once(per_cta, tok_tiles, col_tiles):
    seen = np.zeros((tok_tiles, col_tiles), dtype=int)
    for tiles in per_cta:
        for t, c in tiles:
            seen[t, c] += 1
    return (seen == 1).all()


@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('m', [1, 8, 100])
def test_int8_decode_plan_at_gqa_qkv(m, sms):
    rows, cols = quant.DECODE_TILE
    split_rows, splits = quant.decode_plan(m, K, N, sms)
    assert split_rows % rows == 0 and split_rows > 0
    seen = np.zeros(K, dtype=int)
    for s in range(splits):
        lo, hi = s * split_rows, min((s + 1) * split_rows, K)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    blocks = -(-N // cols) * -(-m // quant.DECODE_ROWS)
    assert blocks * splits >= min(sms, blocks * -(-K // rows))
    assert splits == 1 or blocks * splits <= quant.DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize('m', [256, 300, 2048])
def test_int8_prefill_plan_at_gqa_qkv(m):
    tok, cols = quant.PREFILL_TILE
    for sms in SMS:
        ctas, tok_tiles, col_tiles = quant.prefill_plan(m, N, sms)
        assert (tok_tiles, col_tiles) == (-(-m // tok), N // cols)
        assert 1 <= ctas == min(sms, tok_tiles * col_tiles)
        per_cta = quant.prefill_tiles(m, N, sms)
        assert len(per_cta) == ctas and all(per_cta)
        assert _tiles_once(per_cta, tok_tiles, col_tiles)


@pytest.mark.parametrize('m', [1, 8])
def test_int8_decode_schedule_at_gqa_qkv(int8_weights, m):
    """Per (column tile, split, 128-row box, 64-row tile) the four warps'
    k16 products of x and the converted bytes, summed in the tile's order,
    then scaled (tests/test_torch_int8.py's emulation)."""
    wq, scale = int8_weights
    rng = np.random.default_rng(m)
    x = _bf16(rng.standard_normal((m, K)))
    rows, cols = quant.DECODE_TILE
    split_rows, splits = quant.decode_plan(m, K, N, 132)
    wf = _decode_bytes(wq)
    xs = np.zeros((quant.DECODE_ROWS, K), np.float32)
    xs[:m] = x
    out = np.zeros((m, N), np.float32)
    for c in range(N // cols):
        cs = slice(c * cols, (c + 1) * cols)
        total = np.zeros((quant.DECODE_ROWS, cols), np.float32)
        for sp in range(splits):
            part = np.zeros((4, quant.DECODE_ROWS, cols), np.float32)
            for r in range(sp * split_rows, min((sp + 1) * split_rows, K),
                           rows):
                for r64 in range(r, r + rows, 64):
                    for ks in range(4):
                        ksl = slice(r64 + 16 * ks, r64 + 16 * ks + 16)
                        part[ks] += xs[:, ksl] @ wf[ksl, cs]
            total += ((part[0] + part[1]) + part[2]) + part[3]
        out[:, cs] = (total * scale[cs])[:m]
    want = quant.int8_matmul_reference(_t(x), _t(wq), _t(scale)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_int8_prefill_schedule_at_gqa_qkv(int8_weights):
    """Per output tile of each CTA, per 64-row stage, x in bf16 times the
    tile's A operand (bitwise ``dequantize_weight``) with f32 sums."""
    wq, scale = int8_weights
    m = 256
    x = np.random.default_rng(3).standard_normal((m, K)).astype(np.float32)
    a = _bf16(_prefill_bytes(wq) * scale[None, :])
    np.testing.assert_array_equal(
        a, quant.dequantize_weight(_t(wq), _t(scale)).float().numpy())
    tok, cols = quant.PREFILL_TILE
    rows = quant.PREFILL_STAGE_ROWS
    xb = _bf16(x)
    out = np.full((m, N), np.nan, np.float32)
    for tiles in quant.prefill_tiles(m, N, 132):
        for t, c in tiles:
            cs = slice(c * cols, (c + 1) * cols)
            acc = np.zeros((tok, cols), np.float32)
            for k0 in range(0, K, rows):
                acc += xb[:, k0:k0 + rows] @ a[k0:k0 + rows, cs]
            out[:, cs] = acc
    np.testing.assert_allclose(out, xb @ a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('m', [1, 8])
def test_int4_decode_plan_at_gqa_qkv(m, sms):
    kh = K // 2
    rows, cols = quant4.DECODE_TILE
    split_rows, splits = quant4.decode_plan(K, N, sms)
    assert split_rows % rows == 0 and split_rows > 0
    seen = np.zeros(kh, dtype=int)
    for s in range(splits):
        lo, hi = s * split_rows, min((s + 1) * split_rows, kh)
        assert lo < hi
        seen[lo:hi] += 1
        for r in range(lo, hi, rows):
            blk = quant4.INT4_BLOCK
            assert r // blk == (r + rows - 1) // blk
            assert (kh + r) // blk == (kh + r + rows - 1) // blk
    assert (seen == 1).all()
    col_tiles = N // cols
    assert col_tiles * splits >= min(sms, col_tiles * kh // rows)
    assert splits == 1 or col_tiles * splits <= \
        quant4.DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize('m', [9, 200, 2048])
def test_int4_prefill_plan_and_stages_at_gqa_qkv(m):
    tok, cols = quant4.PREFILL_TILE
    for sms in SMS:
        ctas, tok_tiles, col_tiles = quant4.prefill_plan(m, N, sms)
        assert (tok_tiles, col_tiles) == (-(-m // tok), N // cols)
        assert 1 <= ctas == min(sms, tok_tiles * col_tiles)
        per_cta = quant4.prefill_tiles(m, N, sms)
        assert len(per_cta) == ctas and all(per_cta)
        assert _tiles_once(per_cta, tok_tiles, col_tiles)
    kh, rows = K // 2, quant4.PREFILL_STAGE_ROWS
    stages = quant4.prefill_stages(K)
    assert [s[0] for s in stages] == list(range(0, K, rows))
    for k0, r, half, blk, fold in stages:
        assert half == int(k0 >= kh) and r == k0 - half * kh
        assert blk == k0 // quant4.INT4_BLOCK
        end = k0 + rows
        assert fold == (end % quant4.INT4_BLOCK == 0 or end == kh)


def test_int4_prefill_schedule_at_gqa_qkv():
    """Per output tile, per stage the dot of x with the stage's nibble
    half on exact integers, folded with the block's scale where the plan
    folds (tests/test_torch_quant4.py's emulation)."""
    rng = np.random.default_rng(4)
    m = 9
    x = _t(rng.standard_normal((m, K)).astype(np.float32))
    qd = quant4.quantize_weight_int4(
        _t(rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)),
        block=quant4.INT4_BLOCK)
    packed, scale = qd['q'].to(torch.int32), qd['scale']
    tok, cols = quant4.PREFILL_TILE
    rows = quant4.PREFILL_STAGE_ROWS
    xp = torch.zeros((tok, K))
    xp[:m] = x
    out = torch.full((m, N), float('nan'))
    for tiles in quant4.prefill_tiles(m, N, 132):
        for t, c in tiles:
            cs = slice(c * cols, (c + 1) * cols)
            acc = torch.zeros((tok, cols))
            part = torch.zeros((tok, cols))
            for k0, r, half, blk, fold in quant4.prefill_stages(K):
                q = ((packed[r:r + rows, cs] >> (4 * half)) & 0xF) - 8
                part += xp[:, k0:k0 + rows] @ q.float()
                if fold:
                    acc += part * scale[blk, cs]
                    part.zero_()
            out[:, cs] = acc[:m]
    want = quant4.int4_matmul_reference(x, qd['q'], scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
