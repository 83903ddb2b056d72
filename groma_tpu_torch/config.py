"""Nested model configuration, JSON round-trippable.

TPU-first re-design of the reference's nested HF ``PretrainedConfig`` stack
(reference: groma/model/groma.py:31-83, groma/model/ddetr.py:48-95):
``GromaConfig`` -> {``LlamaConfig``, ``PerceiverConfig`` -> {``ViTConfig``,
``DDETRConfig``}}.  Plain dataclasses — no framework magic; every config
serializes to/from JSON so checkpoints carry their own architecture, matching
the reference's ``to_json_string`` nested-serialization contract.

Static-shape knobs that the reference leaves dynamic (variable NMS survivors,
variable expanded sequence length) are first-class here: ``max_region_num``
slots + validity masks, and a fixed post-surgery sequence length.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field



def _asdict(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _asdict(v)
        out[f.name] = v
    return out


class _ConfigBase:
    def to_dict(self) -> dict:
        d = _asdict(self)
        d['config_type'] = type(self).__name__
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        d.pop('config_type', None)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            sub = _NESTED_FIELDS.get((cls.__name__, f.name))
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ViTConfig(_ConfigBase):
    """DINOv2-style ViT encoder (HF ``Dinov2Config`` semantics).

    Defaults match dinov2-large as used by the reference perceiver
    (reference: groma/model/ddetr.py:104-107): patch 14, hidden 1024, 24
    layers, LayerScale, pre-norm blocks, un-normalized per-layer hidden
    states exposed for downstream feature taps.
    """
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    image_size: int = 518          # pretraining grid; pos-embed interpolated
    num_channels: int = 3
    layerscale_value: float = 1.0
    layer_norm_eps: float = 1e-6
    use_swiglu_ffn: bool = False
    dtype: str = 'bfloat16'


@dataclass(frozen=True)
class DDETRConfig(_ConfigBase):
    """Two-stage Deformable-DETR head (HF ``DeformableDetrConfig`` subset).

    Defaults mirror the reference det-pretrain recipe
    (reference: scripts/det_pretrain.sh flags; groma/train/train_det.py:38-57):
    300 queries, d_model 256, 6+6 layers, 1 feature level, class-agnostic
    (num_labels=1), two-stage with box refinement, dual objectness heads
    (coco / sa1b).
    """
    d_model: int = 256
    num_queries: int = 300
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 1024
    num_feature_levels: int = 1
    enc_n_points: int = 4
    dec_n_points: int = 4
    num_labels: int = 1
    two_stage: bool = True
    with_box_refine: bool = True
    auxiliary_loss: bool = True
    # Hungarian matching costs (reference: groma/train/train_det.py:51-53)
    class_cost: float = 2.0
    bbox_cost: float = 5.0
    giou_cost: float = 2.0
    # loss weights (reference: groma/train/train_det.py:54-56)
    cls_loss_coefficient: float = 2.0
    bbox_loss_coefficient: float = 5.0
    giou_loss_coefficient: float = 2.0
    focal_alpha: float = 0.25
    dropout: float = 0.1
    activation_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: str = 'float32'


@dataclass(frozen=True)
class PerceiverConfig(_ConfigBase):
    """DINOv2 backbone + conv input-projection pyramid + DDETR transformer.

    (reference: groma/model/ddetr.py:98-155  CustomDDETRModel/-Config)
    """
    vit: ViTConfig = field(default_factory=ViTConfig)
    ddetr: DDETRConfig = field(default_factory=DDETRConfig)
    vis_output_layer: int = -1     # which ViT hidden state feeds image tokens
    vis_feature_layers: int = 4    # mean of last-k hidden states feeds DDETR
    image_size: int = 448          # Groma runs the ViT at 448x448 -> 32x32


@dataclass(frozen=True)
class LlamaConfig(_ConfigBase):
    """LLaMA decoder (Vicuna-7B defaults, HF ``LlamaConfig`` semantics)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: str = 'bfloat16'


@dataclass(frozen=True)
class GromaConfig(_ConfigBase):
    """Full grounded-MLLM assembly (reference: groma/model/groma.py:31-83).

    ``max_seq_len`` is the fixed post-surgery device sequence length — the
    TPU-first replacement for the reference's dynamic per-batch re-padding
    (reference: groma/model/groma.py:317-357).
    """
    llm: LlamaConfig = field(default_factory=LlamaConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    num_new_token: int = 114       # 14 added special + 100 region-index
    nms_thres: float = 0.6
    box_score_thres: float = 0.15
    max_region_num: int = 100
    # score fusion exponents (reference: groma/model/groma.py:249)
    score_fuse_coco: float = 0.4
    score_fuse_sa1b: float = 0.6
    # injected ground-truth box score (reference: groma/model/groma.py:262)
    ground_box_score: float = 0.2
    num_image_tokens: int = 256    # 32x32 patches, 2x2 space-to-depth
    max_seq_len: int = 2048
    # region tokenizer shape knobs (reference: groma/model/roi_align.py:196-264)
    region_roi_out: int = 14
    region_num_fuse: int = 5
    region_gn_groups: int = 64
    # inference opt-in: run the region-encoder fuse/pconv convs int8 x
    # int8 on the MXU integer path (~1.5x the bf16 conv rate; exact
    # integer arithmetic, in-graph per-call quantization — checkpoints
    # untouched).  The vision-side analogue of the reference's
    # bitsandbytes LLM switch (reference: groma/eval/run_groma.py:43-61);
    # accuracy with trained weights unvalidated until real ckpts land.
    vision_int8: bool = False

    @property
    def vocab_size(self) -> int:
        return self.llm.vocab_size + self.num_new_token


_NESTED_FIELDS = {
    ('PerceiverConfig', 'vit'): ViTConfig,
    ('PerceiverConfig', 'ddetr'): DDETRConfig,
    ('GromaConfig', 'llm'): LlamaConfig,
    ('GromaConfig', 'perceiver'): PerceiverConfig,
}

_CONFIG_TYPES = {c.__name__: c for c in
                 (ViTConfig, DDETRConfig, PerceiverConfig, LlamaConfig,
                  GromaConfig)}


def config_from_json(s: str):
    d = json.loads(s)
    cls = _CONFIG_TYPES[d.get('config_type', 'GromaConfig')]
    return cls.from_dict(d)


def tiny_groma_config(**overrides) -> GromaConfig:
    """A tiny config for tests/smoke-training (the analogue of the
    reference's debug.sh single-GPU path, reference: scripts/debug.sh)."""
    vit = ViTConfig(hidden_size=32, num_layers=4, num_heads=4, patch_size=14,
                    image_size=56, dtype='float32')
    ddetr = DDETRConfig(d_model=32, num_queries=12, encoder_layers=2,
                        decoder_layers=2, num_heads=4, ffn_dim=64,
                        dtype='float32')
    perceiver = PerceiverConfig(vit=vit, ddetr=ddetr, image_size=56)
    llm = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=4,
                      max_position_embeddings=512, dtype='float32')
    cfg = GromaConfig(llm=llm, perceiver=perceiver, num_new_token=114,
                      max_region_num=8, num_image_tokens=4, max_seq_len=128,
                      region_roi_out=4, region_num_fuse=2,
                      region_gn_groups=8)
    return cfg.replace(**overrides) if overrides else cfg
