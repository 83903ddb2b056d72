"""The benchmark's frozen yardstick: the H100's published peaks, the
roofline bound, and the operations and bytes of the work a window did.

The peaks and ``bound`` are a copy of ``groma_tpu_torch/utils/profiling.py``
kept here, so that a change to the program cannot move them.  Every count
below is the work the configuration's shapes need for the VALID rows only
(prompt tokens, kept regions, live decode rows): padding a kernel computes
is not work, so a later change that drops it cannot push a share past
100 %.  Each input byte is read once and each output byte written once.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA's datasheet, dense, at 700 W)
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12

INT4_BLOCK = 256          # rows that share one int4 scale
HEAD_PAD = 512            # the int4 head's columns are padded to this


def bound(nbytes: float, ops: float, peak: float = H100_BF16_FLOPS):
    """(least seconds, 'bytes' or 'operations') one H100 needs to move
    ``nbytes`` and do ``ops`` operations of a type whose peak is ``peak``."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / peak
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------------ the LLM


def llm_matmuls(llm: dict) -> list:
    """The (K, N) of each weight product of one layer, in the order the
    fused tree holds them: qkv, o, gate|up, down."""
    d, f = llm['hidden_size'], llm['intermediate_size']
    hd = d // llm['num_attention_heads']
    kv = llm['num_key_value_heads'] * hd
    return [(d, d + 2 * kv), (d, d), (d, 2 * f), (f, d)]


def head_shape(llm: dict) -> tuple:
    """(K, N) of the int4 base-vocabulary head, N padded as stored."""
    v = llm['vocab_size']
    return llm['hidden_size'], -(-v // HEAD_PAD) * HEAD_PAD


def int4_bytes(k: int, n: int) -> float:
    """Bytes of one packed int4 (K, N) weight and its f32 block scales."""
    return k * n / 2 + (k // INT4_BLOCK) * n * 4


def int4_matmul_work(shapes: list, rows: int) -> tuple:
    """(bytes, operations) of int4 products over ``shapes`` at ``rows``
    valid rows: every weight byte once, bf16 rows in and out."""
    nbytes = sum(int4_bytes(k, n) + 2 * rows * (k + n) for k, n in shapes)
    ops = sum(2 * rows * k * n for k, n in shapes)
    return nbytes, ops


def decode_step_int4_work(llm: dict, live_rows: int) -> tuple:
    """One decode step's int4 products (every layer and the head) at
    ``live_rows`` live rows."""
    shapes = llm_matmuls(llm) * llm['num_hidden_layers'] + [head_shape(llm)]
    return int4_matmul_work(shapes, live_rows)


def prefill_int4_work(llm: dict, tokens: int) -> tuple:
    """A prefill's layer products at ``tokens`` valid prompt tokens (the
    prefill tile's work; the head's one row runs on the decode tile)."""
    return int4_matmul_work(llm_matmuls(llm) * llm['num_hidden_layers'],
                            tokens)


def paged_attention_work(llm: dict, context: int) -> tuple:
    """One live row's decode attention over ``context`` cached tokens in
    every layer: int8 K and V with one f32 scale per token and head, the
    f32 query in and the f32 output out."""
    d = llm['hidden_size']
    heads = llm['num_key_value_heads']
    hd = d // llm['num_attention_heads']
    per_layer = 2 * context * heads * (hd + 4) + 2 * 4 * d
    ops = 2 * 2 * context * llm['num_attention_heads'] * hd
    n = llm['num_hidden_layers']
    return per_layer * n, ops * n


def llm_token_flops(llm: dict, context: int) -> float:
    """Model FLOPs of one token through the trunk at ``context`` keys
    (itself included), without the head."""
    d = llm['hidden_size']
    mm = sum(2 * k * n for k, n in llm_matmuls(llm))
    attn = 2 * 2 * context * d
    return llm['num_hidden_layers'] * (mm + attn)


def llm_head_flops(llm: dict, extra_vocab: int) -> float:
    """One row through both heads (base vocabulary and the added tokens)."""
    return 2 * llm['hidden_size'] * (llm['vocab_size'] + extra_vocab)


def llm_prefill_flops(llm: dict, tokens: int, extra_vocab: int) -> float:
    """A causal prefill of ``tokens`` valid tokens and one head row."""
    d = llm['hidden_size']
    mm = sum(2 * k * n for k, n in llm_matmuls(llm))
    attn = 2 * 2 * d * tokens * (tokens + 1) / 2
    return (llm['num_hidden_layers'] * (tokens * mm + attn)
            + llm_head_flops(llm, extra_vocab))


# ------------------------------------------------------------ vision


def vit_flops(vit: dict, image_size: int) -> float:
    """DINOv2 over one image: patch embedding, then each layer's four
    projections, its MLP and its attention over 1 + G^2 tokens."""
    d, p = vit['hidden_size'], vit['patch_size']
    g = image_size // p
    t = 1 + g * g
    inner = int(d * vit['mlp_ratio'])
    patch = 2 * g * g * (3 * p * p) * d
    layer = 2 * t * (4 * d * d + 2 * d * inner) + 2 * 2 * t * t * d
    return patch + vit['num_layers'] * layer


def bridge_flops(vit_d: int, llm_d: int, image_tokens: int) -> float:
    """The image-text bridge: Linear(4 C, D), GELU, Linear(D, D)."""
    return 2 * image_tokens * (4 * vit_d * llm_d + llm_d * llm_d)


def ddetr_flops(ddetr: dict, cells: int) -> float:
    """The DDETR head's dense products over ``cells`` feature cells: the
    encoder's and decoder's projections and FFNs and the decoder's
    self-attention (the deformable sampling itself is not counted)."""
    d, f, q = ddetr['d_model'], ddetr['ffn_dim'], ddetr['num_queries']
    heads, levels = ddetr['num_heads'], ddetr['num_feature_levels']
    pts = ddetr['enc_n_points']
    msda = d * d * 2 + d * heads * levels * pts * 3
    enc = 2 * cells * (msda + 2 * d * f)
    dec = 2 * q * (4 * d * d + 2 * q * d + msda + 2 * d * f)
    return ddetr['encoder_layers'] * enc + ddetr['decoder_layers'] * dec


def region_encoder_flops(vit_d: int, llm_d: int, grid: int, regions: int,
                         roi_out: int, num_fuse: int) -> float:
    """The region encoder of one image: the coord convs and ``num_fuse``
    rounds of 3x3 fuse convs over the three upsampled maps (4G, 2G, G),
    then per kept region the three levels' 3x3 RoI convs, the flatten
    linear and the up-projection."""
    cells = sum((grid * 2 ** lvl) ** 2 for lvl in range(3))
    coord = 2 * cells * (vit_d + 2) * vit_d
    fuse = num_fuse * 2 * cells * 9 * vit_d * vit_d
    roi = regions * (3 * 2 * roi_out * roi_out * 9 * vit_d * vit_d
                     + 2 * vit_d * roi_out * roi_out * 1024
                     + 2 * 1024 * llm_d)
    return coord + fuse + roi


def vision_flops(model: dict, regions: int) -> float:
    """The vision front of one request: ViT, bridge, DDETR and the region
    encoder at ``regions`` kept regions."""
    vit, ddetr = model['vit'], model['ddetr']
    size = model['image_size']
    grid = size // vit['patch_size']
    llm_d = model['llm']['hidden_size']
    return (vit_flops(vit, size)
            + bridge_flops(vit['hidden_size'], llm_d, grid * grid // 4)
            + ddetr_flops(ddetr, grid * grid)
            + region_encoder_flops(vit['hidden_size'], llm_d, grid, regions,
                                   model['region_roi_out'],
                                   model['region_num_fuse']))
