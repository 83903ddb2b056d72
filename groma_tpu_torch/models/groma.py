"""Groma, the grounded multimodal LLM (counterpart of
``groma_tpu/models/groma.py``): vision, token-stream surgery, the
split-vocabulary embedding and heads, and the training forward with its
loss, under the reference's parameter names (``perceiver.*``,
``region_encoder.*``, ``img_txt_bridge.*``, ``llm.*``, ``new_input_embs``,
``extra_lm_head``).

Kept from the JAX package: coco^0.4 * sa1b^0.6 score fusion; user refer
boxes injected at score 1.0 and ground-truth boxes at ``ground_box_score``;
fixed-capacity NMS with the argmax-score fallback box; the train-time random
permutation of the kept regions; IoU matching of refer / ground boxes onto
the pool, ``<ground_box>`` rewritten in ids and labels; no gradient into the
ViT, DDETR or the selected boxes (they run under ``torch.no_grad``), while
the bridge and the region encoder train; the loss conditions each label on
the last valid position before it.  Both documented deviations from the
reference are kept too:
  * decode keeps the true key-validity mask instead of an all-ones one;
  * the region permutation is a training option, never applied at
    inference.

Dtypes follow the JAX model: the ViT and the region encoder's convs and
linears run in ``cfg.perceiver.vit.dtype``, DDETR and the image-text
bridge in f32 (flax promotes the bf16 features against f32 params), the
LLM in ``cfg.llm.dtype``; the two heads are f32 (flax promotes a bf16
hidden against their f32 kernels, so the logits are f32).
``full_precision=True`` keeps every parameter in f32 (a trainer's master
weights, as the JAX package's params are); the default stores the ViT and
the region encoder in their compute dtype, as the served path loads them.
``llm_linear_dtype`` stores the LLM trunk's linears in that dtype (the
unquantized inference path keeps them in ``cfg.llm.dtype``: its products
are bit for bit those of a cast at use), the embeddings, norms and heads
staying f32.

``cfg.vision_int8`` runs the region encoder's convs with both operands
int8 (``RegionEncoder(quant=True)``), from the same float parameters.

Generation: ``prefill`` (vision, surgery and the first LLM pass into a
fresh KV cache) and ``decode_step``, as the JAX model's;
``compact_stream`` gathers a stream's valid tokens to the front of a
shorter buffer, ``check_stream_capacity`` refuses a row that does not fit.

Under tensor parallelism (``parallel/mesh.shard_model`` sets
``tp_group``) the embedding tables and the two heads may be cut on their
vocabulary rows: ``embed`` looks up each table's rows across the ranks,
``logits`` gathers each head's columns whole (a greedy argmax then breaks
ties as one process does), and the training loss is the vocab-parallel
NLL (``ops/fused_ce``; without it, the log-softmax of the gathered
logits).  A table whose rows tp does not divide (the 114 new-token rows at
tp = 4) stays whole on every rank, as JAX's fallback leaves it, and every
rank computes it whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from groma_tpu_torch.config import GromaConfig
from groma_tpu_torch.constants import IGNORE_INDEX
from groma_tpu_torch.data.tokenization import SpecialIds
from groma_tpu_torch.models.llama import (LlamaForCausalLM, make_kv_cache,
                                          torch_dtype)
from groma_tpu_torch.models.perceiver import Perceiver
from groma_tpu_torch.models.region_encoder import RegionEncoder
from groma_tpu_torch.ops.bbox import box_iou, cxcywh_to_xyxy
from groma_tpu_torch.ops.fused_ce import fused_nll_sum
from groma_tpu_torch.ops.nms import nms
from groma_tpu_torch.parallel.tensor_parallel import (vocab_embedding,
                                                      vocab_logits)


def _ordinal(mask: torch.Tensor) -> torch.Tensor:
    """Per-row running count of True positions (0-based)."""
    return torch.cumsum(mask.to(torch.int64), dim=-1) - 1


def _gather_rows(table, idx):
    """table (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1,
                                                        table.shape[-1]))


class GromaModel(nn.Module):
    def __init__(self, cfg: GromaConfig, device=None,
                 full_precision: bool = False, llm_linear_dtype=None):
        super().__init__()
        self.cfg = cfg
        vit_d, llm_d = cfg.perceiver.vit.hidden_size, cfg.llm.hidden_size
        vdt = torch_dtype(cfg.perceiver.vit.dtype)
        pdt = torch.float32 if full_precision else vdt
        self.perceiver = Perceiver(cfg.perceiver, device=device,
                                   vit_dtype=pdt, vit_compute_dtype=vdt)
        self.region_encoder = RegionEncoder(
            embed_dims=vit_d, out_dims=llm_d,
            image_size=cfg.perceiver.image_size, roi_out=cfg.region_roi_out,
            num_fuse=cfg.region_num_fuse, gn_groups=cfg.region_gn_groups,
            device=device, dtype=pdt, compute_dtype=vdt,
            quant=cfg.vision_int8)
        self.img_txt_bridge = nn.Sequential(
            nn.Linear(4 * vit_d, llm_d, device=device), nn.GELU(),
            nn.Linear(llm_d, llm_d, device=device))
        self.llm = LlamaForCausalLM(cfg.llm, device=device,
                                    linear_dtype=llm_linear_dtype)
        self.new_input_embs = nn.Embedding(cfg.num_new_token, llm_d,
                                           device=device)
        self.extra_lm_head = nn.Linear(llm_d, cfg.num_new_token, bias=False,
                                       device=device)
        self.tp_group = None

    @property
    def sp(self) -> SpecialIds:
        return SpecialIds.from_base_vocab(self.cfg.llm.vocab_size)

    def embed(self, input_ids):
        """Split-vocabulary embedding lookup."""
        base = self.cfg.llm.vocab_size
        is_new = input_ids >= base
        e_base = vocab_embedding(torch.where(is_new, 0, input_ids),
                                 self.llm.model.embed_tokens.weight, base,
                                 self.tp_group)
        e_new = vocab_embedding(torch.where(is_new, input_ids - base, 0),
                                self.new_input_embs.weight,
                                self.cfg.num_new_token, self.tp_group)
        return torch.where(is_new[..., None], e_new.to(e_base.dtype), e_base)

    def logits(self, hidden):
        """Dual-head vocabulary projection (lm_head + extra_lm_head), in
        the promoted dtype of the hidden and the heads (f32 heads: f32
        logits of a bf16 hidden, as flax computes them)."""
        w = self.llm.lm_head.weight
        hidden = hidden.to(torch.promote_types(hidden.dtype, w.dtype))
        return torch.cat([
            vocab_logits(hidden, w, self.cfg.llm.vocab_size, self.tp_group),
            vocab_logits(hidden, self.extra_lm_head.weight,
                         self.cfg.num_new_token, self.tp_group)], dim=-1)

    # ------------------------------------------------------------- vision

    def vision(self, images, refer_boxes=None, refer_valid=None,
               ground_boxes=None, ground_valid=None, generator=None,
               permute: bool = False, use_flash: bool = False,
               permute_rows: Optional[tuple] = None):
        """(B, H, W, 3) image -> image tokens, the selected region pool and
        its region tokens.  Boxes are normalized cxcywh; refer and ground
        boxes are fixed-capacity (B, R, 4) with validity masks.
        ``permute`` shuffles the kept regions with noise from
        ``generator``; ``permute_rows`` (start, global batch): these rows
        are a data-parallel rank's slice of a larger batch, and the noise
        is drawn for the whole batch and these rows of it taken, so every
        row is shuffled as an unsharded step shuffles it."""
        c = self.cfg
        b = images.shape[0]
        with torch.no_grad():
            hidden_states = self.perceiver.encode_image(images, use_flash)
            ddetr_out = self.perceiver.propose(hidden_states)

        # image tokens: last hidden, CLS dropped, 2x2 space-to-depth
        feats = hidden_states[c.perceiver.vis_output_layer][:, 1:]
        _, l, d = feats.shape
        g = int(round(l ** 0.5))
        f2 = feats.reshape(b, g, g, d)
        img_tokens = torch.cat([f2[:, 0::2, 0::2], f2[:, 1::2, 0::2],
                                f2[:, 0::2, 1::2], f2[:, 1::2, 1::2]], -1)
        img_tokens = self.img_txt_bridge(
            img_tokens.reshape(b, l // 4, 4 * d).to(torch.float32))

        with torch.no_grad():
            keep_idx, keep_mask, all_boxes = self._select_regions(
                ddetr_out, refer_boxes, refer_valid, ground_boxes,
                ground_valid)
            if permute:
                if generator is None:
                    raise ValueError('permute needs a torch.Generator')
                start, total = permute_rows or (0, b)
                noise = torch.rand((total, keep_mask.shape[1]),
                                   generator=generator,
                                   device=generator.device)[start:start + b]
                order = torch.argsort(torch.where(
                    keep_mask, noise.to(keep_mask.device), 2.0), dim=-1)
                keep_idx = torch.gather(keep_idx, 1, order)
                keep_mask = torch.gather(keep_mask, 1, order)
            selected_boxes = _gather_rows(all_boxes, keep_idx.long())

        mlvl = [h[:, 1:] for h in hidden_states[-3:]]
        region_tokens = self.region_encoder(mlvl, selected_boxes)
        return {
            'image_tokens': img_tokens,
            'selected_boxes': selected_boxes,
            'selected_mask': keep_mask,
            'region_tokens': region_tokens,
            'ddetr_out': ddetr_out,
        }

    def _select_regions(self, ddetr_out, refer_boxes, refer_valid,
                        ground_boxes, ground_valid):
        """Proposals + refer + ground boxes -> NMS-kept (indices, mask)
        into the pooled boxes, and the pool."""
        c = self.cfg
        pred_boxes = ddetr_out['pred_boxes']
        s_coco = torch.sigmoid(ddetr_out['logits']['coco'][..., 0])
        s_sa1b = torch.sigmoid(ddetr_out['logits']['sa1b'][..., 0])
        scores = s_coco ** c.score_fuse_coco * s_sa1b ** c.score_fuse_sa1b
        b, q = pred_boxes.shape[:2]
        dev = pred_boxes.device
        boxes, sc, va = [pred_boxes], [scores], [
            torch.ones((b, q), dtype=torch.bool, device=dev)]
        for extra, valid, score in ((refer_boxes, refer_valid, 1.0),
                                    (ground_boxes, ground_valid,
                                     c.ground_box_score)):
            if extra is not None:
                boxes.append(extra.to(pred_boxes.dtype))
                sc.append(valid.to(scores.dtype) * score)
                va.append(valid)
        all_boxes = torch.cat(boxes, dim=1)
        all_scores = torch.cat(sc, dim=1)
        all_valid = torch.cat(va, dim=1)
        keep_idx, keep_mask = nms(cxcywh_to_xyxy(all_boxes), all_scores,
                                  c.nms_thres, c.box_score_thres,
                                  max_num=c.max_region_num, valid=all_valid)
        # fallback: the argmax-score box when nothing survives
        none_kept = ~keep_mask.any(-1)
        arg = torch.argmax(torch.where(all_valid, all_scores, -1.0), dim=-1)
        keep_idx[:, 0] = torch.where(none_kept, arg.to(keep_idx.dtype),
                                     keep_idx[:, 0])
        keep_mask[:, 0] = keep_mask[:, 0] | none_kept
        return keep_idx, keep_mask, all_boxes

    # ------------------------------------------------- token-stream wiring

    def build_stream(self, input_ids, labels, region_slot, base_valid, vis,
                     refer_boxes=None, refer_valid=None, ground_boxes=None,
                     ground_valid=None):
        """Placeholder substitution + masked embedding scatter, fixed
        shapes.  Returns (inputs_embeds, input_ids, labels, valid)."""
        sp = self.sp
        sel_boxes = vis['selected_boxes']
        sel_mask = vis['selected_mask']

        def match(user_boxes):
            iou = box_iou(cxcywh_to_xyxy(user_boxes),
                          cxcywh_to_xyxy(sel_boxes))
            iou = torch.where(sel_mask[:, None, :], iou, -1.0)
            return torch.argmax(iou, dim=-1)                   # (B, Ru)

        def substitute(ids, mask_token_id, matched):
            mask = ids == mask_token_id
            ordn = _ordinal(mask).clamp(0, matched.shape[1] - 1)
            midx = torch.gather(matched, 1, ordn)
            return torch.where(mask, sp.box_idx_start + midx, ids), mask

        matched_refer = None
        if refer_boxes is not None and refer_boxes.shape[1] > 0:
            matched_refer = match(refer_boxes)
            input_ids, _ = substitute(input_ids, sp.rbox, matched_refer)
        if ground_boxes is not None and ground_boxes.shape[1] > 0:
            matched_ground = match(ground_boxes)
            input_ids, gmask = substitute(input_ids, sp.gbox, matched_ground)
            if labels is not None:
                new_lab, _ = substitute(labels, sp.gbox, matched_ground)
                labels = torch.where(gmask, new_lab, labels)

        # unused region slots drop out of attention
        slot_ok = torch.gather(
            sel_mask, 1, region_slot.clamp(0, sel_mask.shape[1] - 1).long())
        valid = base_valid & ((region_slot < 0) | slot_ok)
        if labels is not None:
            labels = torch.where(valid, labels, IGNORE_INDEX)

        emb = self.embed(input_ids)

        def scatter(emb, token_mask, table):
            ordn = _ordinal(token_mask).clamp(0, table.shape[1] - 1)
            return torch.where(token_mask[..., None],
                               _gather_rows(table, ordn).to(emb.dtype), emb)

        emb = scatter(emb, input_ids == sp.image, vis['image_tokens'])
        emb = scatter(emb, input_ids == sp.region, vis['region_tokens'])
        if matched_refer is not None:
            refer_feats = _gather_rows(vis['region_tokens'], matched_refer)
            emb = scatter(emb, input_ids == sp.rfeat, refer_feats)
        return emb, input_ids, labels, valid

    def prepare_stream(self, images, input_ids, region_slot, base_valid,
                       refer_boxes=None, refer_valid=None,
                       ground_boxes=None, ground_valid=None,
                       use_flash: bool = False):
        """Vision + surgery: (inputs_embeds, input_ids, valid, vis), for
        the quantized decoder to consume."""
        vis = self.vision(images, refer_boxes, refer_valid, ground_boxes,
                          ground_valid, use_flash=use_flash)
        emb, ids, _, valid = self.build_stream(input_ids, None, region_slot,
                                               base_valid, vis, refer_boxes,
                                               refer_valid, ground_boxes,
                                               ground_valid)
        return emb, ids, valid, vis

    # --------------------------------------------------------- generation

    def prefill(self, images, input_ids, region_slot, base_valid,
                max_len: int, refer_boxes=None, refer_valid=None,
                ground_boxes=None, ground_valid=None,
                use_flash: bool = False, cache: Optional[dict] = None):
        """Vision + surgery + the first LLM pass, filling a fresh
        ``max_len``-slot KV cache (or ``cache``, one of ``make_kv_cache``
        at index 0 with its mask cleared, which a generator keeps across
        calls).  Returns (the logits at each row's last valid position
        (B, V), the cache, vis, next_pos (B, 1): the position id of the
        first decode step).  The cache's index counts every slot of the
        stream, pads included; the positions count valid tokens only."""
        emb, _, valid, vis = self.prepare_stream(
            images, input_ids, region_slot, base_valid, refer_boxes,
            refer_valid, ground_boxes, ground_valid, use_flash)
        position_ids = _ordinal(valid).clamp(min=0)
        if cache is None:
            cache = make_kv_cache(self.cfg.llm, images.shape[0], max_len,
                                  device=emb.device,
                                  kv_heads=self.llm.model.kv_heads)
        hidden, cache = self.llm.model(emb, valid, position_ids, cache,
                                       use_flash)
        last = torch.argmax(position_ids, dim=-1)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        next_pos = position_ids[rows, last][:, None] + 1
        return self.logits(hidden[rows, last]), cache, vis, next_pos

    def decode_step(self, token_ids, cache, position_ids):
        """One decode step: (B, 1) ids at (B, 1) positions -> the (B, V)
        logits; the cache is updated in place and returned.  Its index may
        be a host int, a (B,) tensor or a 0-d device tensor, advanced in
        place (``LlamaModel.forward``); with a tensor index the step reads
        nothing back, so a CUDA graph can capture it."""
        valid = torch.ones_like(token_ids, dtype=torch.bool)
        hidden, cache = self.llm.model(self.embed(token_ids), valid,
                                       position_ids, cache)
        return self.logits(hidden[:, -1]), cache

    # ------------------------------------------------------------ forward

    def forward(self, images, input_ids, region_slot, base_valid,
                labels=None, refer_boxes=None, refer_valid=None,
                ground_boxes=None, ground_valid=None, generator=None,
                permute: bool = False, use_flash: bool = False,
                fused_ce: bool = True, permute_rows: Optional[tuple] = None):
        """Training forward through the LLM -> {'loss', 'nll_sum',
        'n_tokens', 'vis', 'valid', 'final_input_ids'}, plus 'logits'
        (B, S, V) f32 when not ``fused_ce``.  The loss is the mean NLL of
        the labels, each conditioned on the last valid position before it:
        'nll_sum' over 'n_tokens' supervised positions (a data-parallel
        step divides by the global count).  ``permute_rows``: see
        ``vision``."""
        vis = self.vision(images, refer_boxes, refer_valid, ground_boxes,
                          ground_valid, generator=generator, permute=permute,
                          use_flash=use_flash, permute_rows=permute_rows)
        emb, input_ids, labels, valid = self.build_stream(
            input_ids, labels, region_slot, base_valid, vis, refer_boxes,
            refer_valid, ground_boxes, ground_valid)
        position_ids = _ordinal(valid).clamp(min=0)
        hidden, _ = self.llm.model(emb, valid, position_ids,
                                   use_flash=use_flash)
        out = {'vis': vis, 'valid': valid, 'final_input_ids': input_ids,
               'loss': None}
        if not fused_ce:
            out['logits'] = self.logits(hidden)
        if labels is None:
            return out
        # in the fixed-capacity stream, the token after a gap of masked
        # region slots follows the last valid position, not the slot
        # physically before it (for gapless templates this is j - 1)
        pos = torch.arange(valid.shape[1], device=valid.device)
        last_valid = torch.cummax(torch.where(valid, pos, -1), dim=1).values
        prev_valid = F.pad(last_valid[:, :-1], (1, 0), value=-1)
        ok = (labels != IGNORE_INDEX) & (prev_valid >= 0)
        src = prev_valid.clamp(min=0)
        safe = torch.where(ok, labels, 0)
        if fused_ce:
            nll_sum = fused_nll_sum(
                _gather_rows(hidden, src),
                (self.llm.lm_head.weight.T, self.extra_lm_head.weight.T),
                safe, ok, chunk=512, group=self.tp_group,
                full_cols=(self.cfg.llm.vocab_size, self.cfg.num_new_token))
        else:
            logp = torch.log_softmax(_gather_rows(out['logits'], src), -1)
            nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
            nll_sum = torch.where(ok, nll, 0.0).sum()
        out['nll_sum'], out['n_tokens'] = nll_sum, ok.sum()
        out['loss'] = nll_sum / ok.sum().clamp(min=1)
        return out


def check_stream_capacity(valid, out_len: int):
    """Raise ValueError naming the row with the most valid tokens if any
    row of ``valid`` (B, S) holds more than ``out_len`` (the tokens
    ``compact_stream`` would drop).  Reads the mask on the host."""
    counts = torch.as_tensor(valid).sum(dim=-1).cpu()
    if counts.numel() and int(counts.max()) > out_len:
        bad = int(counts.argmax())
        raise ValueError(
            f'compact_stream capacity exceeded: row {bad} has '
            f'{int(counts[bad])} valid tokens > out_len={out_len}; prompt '
            f'tokens would be dropped: grow out_len or shrink the template')


def compact_stream(emb, valid, out_len: int, ids=None):
    """Gather each row's valid positions, in order, to the front of an
    ``out_len`` buffer: (emb (B, out_len, D), valid (B, out_len)[, ids]).
    Exact for the LLM: causal order is kept and the rope positions are the
    compacted running counts already.  A row with more than ``out_len``
    valid tokens raises (``check_stream_capacity``, one host read)."""
    check_stream_capacity(valid, out_len)
    return _gather_valid_first(emb, valid, out_len, ids)


def _gather_valid_first(emb, valid, out_len: int, ids=None):
    """``compact_stream`` without its capacity check (no host read), for a
    timed loop whose caller checked the mask once."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    take = order[:, :out_len]
    cemb = _gather_rows(emb, take)
    cvalid = torch.gather(valid, 1, take)
    if ids is not None:
        return cemb, cvalid, torch.gather(ids, 1, take)
    return cemb, cvalid
