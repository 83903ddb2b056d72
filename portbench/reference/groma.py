"""Plain PyTorch reference of the served Groma path, in float32 with TF32
off: DINOv2 at 448, the image-text bridge, the region encoder (multi-level
fusion and RoIAlign), the token surgery, and a LLaMA-architecture decoder
whose weights are quantized here to int4 as the configuration states
(symmetric, one scale per 256 rows and column), with the int8 KV cache
of the served configuration (symmetric, one scale per token and head).

It imports nothing of the program.  It takes the weights the benchmark
draws (``portbench.weights``), quantizes them itself, and reads the
program's outputs only to judge them: the served tokens, and the region
boxes and mask the program selected.

Departures from the published descriptions, each as the served Groma
path has it:
* DINOv2's position table is drawn at the 32 x 32 deploy grid, not
  interpolated from 37 x 37 (the weights are random);
* the region encoder reads the normalized cxcywh boxes times the image
  size as (x1, y1, x2, y2), the quirk Groma's released checkpoints were
  trained with, and its RoIAlign strides are 14/8, 14/4, 14/2;
* prompt tokens attend over exact keys and values (the prefill computes
  them in one pass); every decoded token attends over int8 keys and
  values, its own included (the decode reads the cache back);
* the region selection (DDETR, NMS, the cap of 100) is followed from the
  program's output, not recomputed.  The two-stage decoder gives the
  query of each rank of the encoder's top 300 (of 1,024 scores) that
  rank's learned embedding, so its boxes and scores follow the exact
  order of near-tied scores, which a bf16 and an f32 DINOv2 do not share;
  the served path exposes neither that order nor the encoder's scores,
  so no comparison of DDETR's numbers can be made from its output.  The
  selection is held only to NMS's own rule (``check_served``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30


def strict_f32():
    """Matmuls and convolutions in true float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The precision the reference computes in.  ``None``: the
    configuration's (f32 products, the int8 KV cache).  'step-down': the
    control, one step below each precision the configuration states:
    every product's activation input rounded to fp8 e4m3 with its own
    per-row absmax scale (below bf16), and the KV cache in int4 (below
    int8)."""

    def __init__(self, kind=None):
        if kind not in (None, 'step-down'):
            raise ValueError(f'unknown precision {kind!r}')
        self.kind = kind
        self.kv_levels = 127 if kind is None else 7

    def __call__(self, x):
        if self.kind is None:
            return x
        amax = x.abs().amax(-1, keepdim=True).clamp(min=1e-12)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _f(t):
    return t.to(torch.float32)


def linear(x, w, b=None, act=None):
    y = (act(x) if act else x) @ _f(w).T
    return y if b is None else y + _f(b)


def conv(x, w, b=None, act=None, padding=0, stride=1):
    """NCHW convolution, the input rounded by ``act`` over channels."""
    if act is not None and act.kind is not None:
        x = act(x.movedim(1, -1)).movedim(-1, 1)
    return F.conv2d(x, _f(w), None if b is None else _f(b), stride=stride,
                    padding=padding)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], _f(p[name + '.weight']),
                        _f(p[name + '.bias']), eps)


# ------------------------------------------------------------- DINOv2


def vit(image, p, cfg, act):
    """(H, W, 3) normalized pixels -> the hidden states (embedding output
    and each layer's output, before the final norm), each (1 + G^2, C)."""
    pre = 'perceiver.vis_encoder.'
    v = cfg['vit']
    d, heads = v['hidden_size'], v['num_heads']
    eps = v['layer_norm_eps']
    x = conv(image.permute(2, 0, 1)[None],
             p[pre + 'embeddings.patch_embeddings.projection.weight'],
             p[pre + 'embeddings.patch_embeddings.projection.bias'], act,
             stride=v['patch_size'])
    x = x.flatten(2)[0].T
    x = torch.cat([_f(p[pre + 'embeddings.cls_token'])[0], x])
    x = x + _f(p[pre + 'embeddings.position_embeddings'])[0]
    states = [x]
    for i in range(v['num_layers']):
        q = f'{pre}encoder.layer.{i}.'
        h = layer_norm(x, p, q + 'norm1', eps)
        a = q + 'attention.attention.'
        qkv = [linear(h, p[a + n + '.weight'], p[a + n + '.bias'], act)
               .reshape(-1, heads, d // heads).transpose(0, 1)
               for n in ('query', 'key', 'value')]
        s = (act(qkv[0]) @ act(qkv[1]).transpose(1, 2)) / math.sqrt(d // heads)
        o = (act(torch.softmax(s, -1)) @ act(qkv[2])).transpose(0, 1)
        o = linear(o.reshape(-1, d), p[q + 'attention.output.dense.weight'],
                   p[q + 'attention.output.dense.bias'], act)
        x = x + o * _f(p[q + 'layer_scale1.lambda1'])
        h = layer_norm(x, p, q + 'norm2', eps)
        h = F.gelu(linear(h, p[q + 'mlp.fc1.weight'], p[q + 'mlp.fc1.bias'],
                          act))
        h = linear(h, p[q + 'mlp.fc2.weight'], p[q + 'mlp.fc2.bias'], act)
        x = x + h * _f(p[q + 'layer_scale2.lambda1'])
        states.append(x)
    return states


def image_tokens(states, p, act):
    """The last hidden state without CLS, 2 x 2 space-to-depth, through
    the bridge (Linear, GELU, Linear) -> (G^2 / 4, D)."""
    f = states[-1][1:]
    g = int(round(f.shape[0] ** 0.5))
    f = f.reshape(g, g, -1)
    f = torch.cat([f[0::2, 0::2], f[1::2, 0::2], f[0::2, 1::2],
                   f[1::2, 1::2]], -1).reshape(g * g // 4, -1)
    h = F.gelu(linear(f, p['img_txt_bridge.0.weight'],
                      p['img_txt_bridge.0.bias'], act))
    return linear(h, p['img_txt_bridge.2.weight'], p['img_txt_bridge.2.bias'],
                  act)


# ------------------------------------------------------- region encoder


def roi_align(feat, rois, out, scale, ratio=2):
    """mmcv RoIAlign (aligned): feat (C, H, W), rois (R, 4) xyxy in input
    pixels -> (R, C, out, out).  Each bin averages ratio^2 bilinear samples;
    a sample beyond [-1, size] reads 0, one inside is clamped to the map."""
    c, h, w = feat.shape
    x1 = rois[:, 0] * scale - 0.5
    y1 = rois[:, 1] * scale - 0.5
    bw = (rois[:, 2] * scale - 0.5 - x1) / out
    bh = (rois[:, 3] * scale - 0.5 - y1) / out
    k = torch.arange(out * ratio, device=feat.device, dtype=torch.float32)
    frac = (k // ratio) + ((k % ratio) + 0.5) / ratio       # bin + sub-step
    ys = y1[:, None] + frac[None] * bh[:, None]             # (R, out*ratio)
    xs = x1[:, None] + frac[None] * bw[:, None]

    def corners(t, size):
        inside = (t >= -1.0) & (t <= size)
        t = t.clamp(min=0.0)
        lo = t.floor().clamp(max=size - 1)
        top = lo >= size - 1
        t = torch.where(top, lo, t)
        hi = torch.where(top, lo, lo + 1)
        frac = t - lo
        return lo.long(), hi.long(), frac, inside

    y0, y1i, ly, yok = corners(ys, h)
    x0, x1i, lx, xok = corners(xs, w)
    r = rois.shape[0]
    pooled = torch.empty((r, c, out, out), device=feat.device)
    for i in range(r):
        rows = (feat[:, y0[i]] * (1 - ly[i])[None, :, None]
                + feat[:, y1i[i]] * ly[i][None, :, None])
        rows = rows * yok[i][None, :, None]                # (C, S, W)
        v = (rows[:, :, x0[i]] * (1 - lx[i])[None, None]
             + rows[:, :, x1i[i]] * lx[i][None, None])
        v = v * xok[i][None, None]                         # (C, S, S)
        pooled[i] = v.reshape(c, out, ratio, out, ratio).mean((2, 4))
    return pooled


def region_tokens(states, boxes, p, cfg, act):
    """The last three hidden states and (R, 4) normalized cxcywh boxes ->
    (R, D) region tokens."""
    pre = 'region_encoder.'
    size = cfg['image_size']
    nfuse, groups = cfg['region_num_fuse'], cfg['region_gn_groups']
    roi_out = cfg['region_roi_out']
    maps = []
    for s in states[-3:]:
        f = s[1:]
        g = int(round(f.shape[0] ** 0.5))
        maps.append(f.T.reshape(1, -1, g, g))
    base = maps[0].shape[-1]
    shapes = [base * 4, base * 2, base]
    feats = []
    for lvl, (m, n) in enumerate(zip(maps, shapes)):
        m = m if m.shape[-1] == n else F.interpolate(
            m, size=(n, n), mode='bilinear', align_corners=True)
        xs = torch.linspace(-1.0, 1.0, n, device=m.device)
        coord = torch.stack([xs[None, :].expand(n, n),
                             xs[:, None].expand(n, n)])[None]
        feats.append(conv(torch.cat([m, coord], 1),
                          p[f'{pre}mlvl_fuse.input_conv.{lvl}.weight'],
                          p[f'{pre}mlvl_fuse.input_conv.{lvl}.bias'], act))
    d = feats[0].shape[1]
    shuffle = d // 4
    remain = d - 2 * shuffle
    for r in range(nfuse):
        q = f'{pre}mlvl_fuse.fuse_convs.{r}.'
        fused = []
        for lvl in range(3):
            top, down = min(lvl + 1, 2), max(lvl - 1, 0)
            n = feats[lvl].shape[-1]

            def resize(t):
                return t if t.shape[-1] == n else F.interpolate(
                    t, size=(n, n), mode='bilinear', align_corners=True)
            x = torch.cat([feats[lvl][:, :remain],
                           resize(feats[top][:, remain + shuffle:]),
                           resize(feats[down][:, remain:remain + shuffle])],
                          1)
            x = conv(x, p[q + 'conv.weight'], None, act, padding=1)
            x = F.group_norm(x, groups, _f(p[q + 'gn.weight']),
                             _f(p[q + 'gn.bias']), 1e-5)
            fused.append(torch.relu(x))
        feats = fused
    q = pre + 'roi_align.'
    def ln(x, i):
        return F.layer_norm(x, x.shape[-1:], _f(p[f'{q}pos_embedd.{i}.weight']),
                            _f(p[f'{q}pos_embedd.{i}.bias']), 1e-6)

    def lin(x, i):
        return torch.relu(linear(x, p[f'{q}pos_embedd.{i}.weight'],
                                 p[f'{q}pos_embedd.{i}.bias'], act))
    pos = ln(lin(ln(lin(boxes, 0), 2), 3), 5)
    rois = boxes * size
    acc = 0.0
    for lvl, stride in enumerate((14 / 8, 14 / 4, 14 / 2)):
        pooled = roi_align(feats[lvl][0], rois, roi_out, 1.0 / stride)
        acc = acc + conv(pooled, p[f'{q}pconvs.{lvl}.weight'],
                         p[f'{q}pconvs.{lvl}.bias'], act, padding=1)
    x = torch.relu(acc).reshape(boxes.shape[0], -1)
    x = linear(x, p[q + 'flatten_linear.weight'], p[q + 'flatten_linear.bias'],
               act) + pos
    return linear(x, p[q + 'updims.weight'], p[q + 'updims.bias'], act)


# --------------------------------------------------------- quantization


def true_div(x, d: float):
    """x / d as an IEEE division (a Python divisor would let the card
    multiply by its reciprocal instead)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def int4_dequant(w, block=256):
    """A (N, K) weight -> the (K, N) f32 kernel its int4 form stands for:
    per (block of K, column) scale absmax / 7, values rounded and clipped
    to [-7, 7]."""
    kern = _f(w).T
    k, n = kern.shape
    if k % block:
        raise ValueError(f'int4 needs K a multiple of {block}, got {k}')
    blocks = kern.reshape(k // block, block, n)
    amax = blocks.abs().amax(1, keepdim=True)
    scale = torch.where(amax > 0, true_div(amax, 7.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -7, 7)
    return (q * scale).reshape(k, n)


def kv_tokens(x, levels: int = 127):
    """(..., D) keys or values -> their symmetric integer form dequantized
    (int8: ``levels`` 127; int4: 7): per row scale absmax / levels, values
    rounded and clipped to [-levels, levels]."""
    a = x.abs().amax(-1, keepdim=True)
    s = torch.where(a > 0, true_div(a, float(levels)), torch.ones_like(a))
    return torch.clamp(torch.round(x / s), -levels, levels) * s


# ------------------------------------------------------------ the LLM


def rope(x, pos, theta):
    """HF half-rotation RoPE: x (H, S, hd), pos (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd))
    ang = pos.to(torch.float32)[:, None] * inv[None]
    emb = torch.cat([ang, ang], -1)
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(w)


def decoder_layer(xs, prompts, p, llm, act):
    """One decoder layer over each sequence in ``xs`` (S_i, D); the first
    ``prompts[i]`` tokens of a sequence attend over exact keys and
    values, the later ones over the quantized cache (``act.kv_levels``)."""
    d = llm['hidden_size']
    heads, kvh = llm['num_attention_heads'], llm['num_key_value_heads']
    hd = d // heads
    eps, theta = llm['rms_norm_eps'], llm['rope_theta']
    w = {n: int4_dequant(p[n]) for n in p if n.endswith('proj.weight')}

    def find(suffix):
        return next(v for n, v in w.items() if n.endswith(suffix))
    out = []
    for x, n_prompt in zip(xs, prompts):
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        h = rms_norm(x, next(v for n, v in p.items()
                             if n.endswith('input_layernorm.weight')), eps)
        q = (act(h) @ find('q_proj.weight')).reshape(s, heads, hd)
        k = (act(h) @ find('k_proj.weight')).reshape(s, kvh, hd)
        v = (act(h) @ find('v_proj.weight')).reshape(s, kvh, hd)
        q = rope(q.transpose(0, 1), pos, theta)
        k = rope(k.transpose(0, 1), pos, theta)
        v = v.transpose(0, 1)
        rep = heads // kvh
        k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril()
        bias = torch.where(causal, 0.0, NEG)

        def attend(kk, vv):
            sc = (act(q) @ act(kk).transpose(1, 2)) / math.sqrt(hd) + bias
            return act(torch.softmax(sc, -1)) @ act(vv)
        o = attend(k, v)
        if n_prompt < s:
            o8 = attend(kv_tokens(k, act.kv_levels),
                        kv_tokens(v, act.kv_levels))
            o = torch.cat([o[:, :n_prompt], o8[:, n_prompt:]], 1)
        o = o.transpose(0, 1).reshape(s, d)
        x = x + act(o) @ find('o_proj.weight')
        h = rms_norm(x, next(v for n, v in p.items()
                             if n.endswith('post_attention_layernorm.weight')),
                     eps)
        h = F.silu(act(h) @ find('gate_proj.weight')) * (
            act(h) @ find('up_proj.weight'))
        out.append(x + act(h) @ find('down_proj.weight'))
    return out


def logits(x, p, llm, act):
    """Final norm and both heads: the int4 base-vocabulary head and the
    bf16 head of the added tokens -> (S, V + added)."""
    h = rms_norm(x, p['llm.model.norm.weight'], llm['rms_norm_eps'])
    base = act(h) @ int4_dequant(p['llm.lm_head.weight'])
    extra = act(h) @ _f(p['extra_lm_head.weight']).T
    return torch.cat([base, extra], -1)


def surgery(ids, slot, valid, mask, img, reg, emb_base, emb_new,
            base_vocab, image_id, region_id):
    """The fixed stream layout -> the embeddings of its valid tokens: the
    k-th ``<image>`` slot takes image token k, the k-th ``<region>`` slot
    region token k, a region pair whose region was not kept drops out,
    every other id its embedding row."""
    keep = valid & ((slot < 0) | mask[slot.clamp(min=0)])
    new = ids >= base_vocab
    e = torch.where(new[:, None], _f(emb_new[(ids - base_vocab).clamp(min=0)]),
                    _f(emb_base[ids.clamp(max=base_vocab - 1)]))
    is_img, is_reg = ids == image_id, ids == region_id
    e[is_img] = img[:int(is_img.sum())]
    e[is_reg] = reg[:int(is_reg.sum())]
    return e[keep]
