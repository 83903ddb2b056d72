"""Paged single-token decode attention over an int8 KV page pool.

Counterpart of ``groma_tpu/ops/paged_attention.py``: every slot of the
serving engine owns an ordered list of 128-token pages in one shared pool
per layer, (P, H, PAGE, D) int8 with (P, H, PAGE) f32 scales, and a table
row of page ids whose unused tail repeats the last used id.  Page 0 is the
trash page: the allocator never hands it out, and frozen rows write there.
``paged_int8_decode_attention`` replaces the TPU kernel ``_kernel`` with the
hand-written CUDA kernel in ``csrc/paged_attention.cu``: one (slot, head)
split over a thread-block cluster, each CTA an online softmax over a run of
the row's pages, the runs merged in rank order.

* ``paged_int8_decode_attention_plain`` is the plain PyTorch version, on any
  device, in the TPU kernel's order: q quantized per (b, h), then page by
  page an online softmax (running max, denominator, accumulator) with p
  requantized per page with that page's own scale.  Integer dots in f64,
  where they are exact.  A row with length 0 keeps the running max at
  -1e30, so each page adds uniform p (the TPU kernel's result, not 0).
* ``paged_attention_reference`` is the JAX package's oracle: gather each
  slot's pages into a contiguous cache, then the whole-row int8 chain.
* ``paged_plan`` (the cluster's size) and ``page_runs`` (each CTA's pages)
  are the kernel's host-side schedule, in plain Python for the tests.
* ``paged_int8_decode_attention`` takes the plain version only for CPU
  tensors; on CUDA tensors it launches the kernel or raises.
  ``paged_int8_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from groma_tpu_torch.ops.quant import true_div

PAGE = 128
HEAD_DIM = 128
NEG = -1e30
MAX_CLUSTER = 8         # the portable cluster size: the kernel's limit
PLAN_CLUSTER = 4        # the plan's: larger clusters are placed worse
PAGED_CTAS_PER_SM = 2   # the kernel's ring of 3 pages: 101 KB a CTA


def paged_plan(b: int, h: int, np_: int, sms: int) -> int:
    """The CTAs of one (slot, head)'s cluster on a card with ``sms`` SMs:
    as many as fill about one wave of ``PAGED_CTAS_PER_SM`` a SM, at least
    1 and at most ``PLAN_CLUSTER`` or the table's NP pages."""
    return max(1, min(PLAN_CLUSTER, np_,
                      PAGED_CTAS_PER_SM * sms // (b * h)))


def page_runs(n: int, c: int) -> list:
    """Each rank's [start, end) of a row's ``n`` pages in a cluster of
    ``c``: contiguous runs, in the kernel's split (a rank may get none)."""
    return [(r * n // c, (r + 1) * n // c) for r in range(c)]


def _page_loop(q, kpool, ks, vpool, vs, table, lengths):
    """The TPU kernel's page loop over every column of ``table`` -> (m, l,
    acc, units): the running max (B, H, 1), denominator (B, H, 1) and
    accumulator (B, H, D) after the last page, and per page its r and the
    running max after it.  Positions are 128 p + offset against
    ``lengths``."""
    b, h, _, d = q.shape
    qf = q[:, :, 0].to(torch.float32)                            # (B, H, D)
    amax = qf.abs().amax(-1, keepdim=True)
    qs = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q8 = torch.round(qf / qs).double()
    qscale = qs * torch.full((), d ** -0.5, dtype=torch.float32,
                             device=q.device)
    pos = torch.arange(PAGE, device=q.device)
    m = torch.full((b, h, 1), NEG, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    units = []                      # per page: r and the running max after it
    for p in range(table.shape[1]):
        pid = table[:, p].long()
        s = torch.einsum('bhd,bhsd->bhs', q8, kpool[pid].double()).float()
        bias = torch.where(p * PAGE + pos[None] < lengths[:, None].long(),
                           0.0, NEG)[:, None, :]
        s = s * qscale * ks[pid] + bias
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pv = torch.exp(s - m_new)
        l = l * corr + pv.sum(-1, keepdim=True)
        m = m_new
        ps = pv * vs[pid]
        r = ps.amax(-1, keepdim=True)
        r = torch.where(r > 0, true_div(r, 127.0), torch.ones_like(r))
        p8 = torch.round(ps / r)
        o = torch.einsum('bhs,bhsd->bhd', p8.double(),
                         vpool[pid].double()).float()
        acc = acc * corr + o * r
        units.append((r, m_new))
    return m, l, acc, units


def _walk_pages(q, kpool, ks, vpool, vs, table, lengths):
    """The TPU kernel's page loop -> (out (B, H, 1, D), p8 step (B, H, 1, 1))."""
    m, l, acc, units = _page_loop(q, kpool, ks, vpool, vs, table, lengths)
    denom = torch.clamp(l, min=1e-30)
    # a p8 unit of page p moves the output by at most 127 r_p, carried to
    # the end by exp(m_p - m_final), over the final denominator
    step = torch.stack([r * torch.exp(mp - m) for r, mp in units]).amax(0)
    return (acc / denom)[:, :, None, :], (127.0 * step / denom)[..., None]


def paged_int8_decode_attention_plain(q, kpool, ks, vpool, vs, table,
                                      lengths, with_step: bool = False):
    """q (B, H, 1, D); kpool/vpool (P, H, PAGE, D) int8; ks/vs (P, H, PAGE)
    f32; table (B, NP) int page ids (tails repeat the last used id);
    lengths (B,) valid kv positions -> (B, H, 1, D) f32.

    ``with_step``: also return (B, H, 1, 1), the most one requantized-p
    unit of any page can move an output.  Two implementations whose f32
    exp or sums differ in the last bit may round a p on a .5 tie the other
    way, by this much."""
    out, step = _walk_pages(q, kpool, ks, vpool, vs, table, lengths)
    return (out, step) if with_step else out


def paged_attention_reference(q, kpool, ks, vpool, vs, table, lengths):
    """The JAX package's oracle: gather each slot's pages into a
    contiguous cache and run the whole-row int8 decode chain."""
    from groma_tpu_torch.models.llama_quant import _int8_cache_attention
    b, np_ = table.shape
    t = table.long()

    def gather(pool):
        g = pool[t]                                 # (B, NP, H, PAGE, ...)
        g = g.transpose(1, 2)
        return g.reshape(b, g.shape[1], np_ * PAGE, *g.shape[4:])
    pos = torch.arange(np_ * PAGE, device=q.device)[None, :]
    bias = torch.where(pos < lengths[:, None].long(), 0.0,
                       NEG)[:, None, None, :].to(torch.float32)
    return _int8_cache_attention(q, gather(kpool), gather(ks), gather(vpool),
                                 gather(vs), bias)


def paged_int8_decode_attention(q, kpool, ks, vpool, vs, table, lengths,
                                cluster=None):
    """Same contract as the plain version.  CUDA tensors: q f32 or bf16
    (cast to f32 as the TPU kernel does), D = 128, table and lengths int32,
    all contiguous, pools and scales 16-byte aligned; table ids must lie in
    [0, P).  ``cluster``: the CTAs of a (slot, head), 1..8 (default
    ``paged_plan``'s)."""
    if q.device.type == 'cpu':
        return paged_int8_decode_attention_plain(q, kpool, ks, vpool, vs,
                                                 table, lengths)
    if q.device.type != 'cuda':
        raise ValueError(f'paged_int8_decode_attention: unsupported device '
                         f'{q.device}')
    b, h, one, d = q.shape
    n_pool = kpool.shape[0]
    np_ = table.shape[1] if table.dim() == 2 else 0
    if (one != 1 or d != HEAD_DIM or kpool.shape != (n_pool, h, PAGE, d)
            or vpool.shape != kpool.shape or ks.shape != (n_pool, h, PAGE)
            or vs.shape != ks.shape or table.shape != (b, np_) or np_ < 1
            or lengths.shape != (b,)):
        raise ValueError(
            f'paged_int8_decode_attention: shapes q {tuple(q.shape)}, pool '
            f'{tuple(kpool.shape)}, scales {tuple(ks.shape)}, table '
            f'{tuple(table.shape)}, lengths {tuple(lengths.shape)}; the '
            f'kernel takes D = {HEAD_DIM} and {PAGE}-token pages')
    if (kpool.dtype, vpool.dtype, ks.dtype, vs.dtype, table.dtype,
            lengths.dtype) != (torch.int8, torch.int8, torch.float32,
                               torch.float32, torch.int32, torch.int32) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('paged_int8_decode_attention: dtypes must be q '
                         'f32/bf16, pools int8, scales f32, table and '
                         'lengths int32')
    tensors = (kpool, ks, vpool, vs, table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError('paged_int8_decode_attention: tensors on different '
                         'devices')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('paged_int8_decode_attention: the kernel takes '
                         'contiguous tensors')
    if any(t.data_ptr() % 16 for t in (kpool, ks, vpool, vs)):
        raise ValueError('paged_int8_decode_attention: pools and scales '
                         'must be 16-byte aligned (bulk copies)')
    from groma_tpu_torch.ops.cuda_lib import check, library, stream_ptr
    c = cluster or paged_plan(
        b, h, np_, torch.cuda.get_device_properties(q.device)
        .multi_processor_count)
    if not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f'paged_int8_decode_attention: cluster {c} not in '
                         f'1..{MAX_CLUSTER}')
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    status = library().groma_paged_attention(
        qf.data_ptr(), kpool.data_ptr(), ks.data_ptr(), vpool.data_ptr(),
        vs.data_ptr(), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, np_, d, c, stream_ptr(q))
    check(status, 'paged_int8_decode_attention')
    paged_int8_decode_attention.launches += 1
    return out


paged_int8_decode_attention.launches = 0


def make_kv_page_pool(cfg, num_pages: int, device=None) -> dict:
    """Per-layer int8 page pools and their f32 scales, zeroed; page 0 is
    the trash page."""
    hd = cfg.hidden_size // cfg.num_heads
    shape = (num_pages, cfg.num_kv_heads, PAGE, hd)
    nl = cfg.num_layers
    return {
        'k': [torch.zeros(shape, dtype=torch.int8, device=device)
              for _ in range(nl)],
        'v': [torch.zeros(shape, dtype=torch.int8, device=device)
              for _ in range(nl)],
        'k_scale': [torch.zeros(shape[:-1], device=device)
                    for _ in range(nl)],
        'v_scale': [torch.zeros(shape[:-1], device=device)
                    for _ in range(nl)],
    }


def insert_prefill_pages(pools: dict, one: dict, row: int,
                         page_ids: torch.Tensor, valid=None) -> dict:
    """Scatter row ``row`` of a contiguous int8 prefill cache ((B, H, S, D)
    leaves, S a multiple of PAGE) into the pools at ``page_ids`` ((S/PAGE,)
    ids; entries past the prompt's pages must be 0, the trash page), in
    place; returns ``pools``.

    ``valid`` ((S,) bool) compacts the stream first: a stable partition
    moves the valid positions to the front (exact, because the rope
    positions are already the compacted cumsum indices), so the paged
    kernel can mask by length alone."""
    perm = None
    if valid is not None:
        perm = torch.argsort((~valid.bool()).to(torch.int8), stable=True)
    ids = page_ids.long()
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        for pool, leaf in zip(pools[key], one[key]):
            x = leaf[row]
            if perm is not None:
                x = x[:, perm]
            h, s = x.shape[0], x.shape[1]
            x = x.reshape(h, s // PAGE, PAGE, *x.shape[2:]).transpose(0, 1)
            pool[ids] = x
    return pools
