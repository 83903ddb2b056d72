"""Config-driven dataset registry + multi-dataset concatenation.

(reference: groma/data/build.py:18-62 build_multi_datasets — mmcv
Config.fromfile python configs, per-dataset ``ratio`` subsampling, concat.)
The config format is a python file defining ``datasets = [dict(...), ...]``
exactly like the reference's groma/data/configs/*.py.
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import List, Sequence

import numpy as np

DATASETS = {}


def register(name: str):
    def deco(cls):
        DATASETS[name] = cls
        return cls
    return deco


def _register_builtin():
    from groma_tpu_torch.data.datasets import det_datasets as dd
    from groma_tpu_torch.data.datasets import vl_datasets as vd
    DATASETS.update({
        'ClassAgnosticCoco': dd.ClassAgnosticCoco,
        'ClassAgnosticSA1B': dd.ClassAgnosticSA1B,
        'RefCOCO': vd.RefCOCO,
        'RefCOCOCap': vd.RefCOCOCap,
        'Flickr30k': vd.Flickr30k,
        'SingleRoundVG': vd.SingleRoundVG,
        'MultiRoundsVG': vd.MultiRoundsVG,
        'COCODet': vd.COCODet,
        'LVISDet': vd.LVISDet,
        'Grit': vd.Grit,
        'LLaVAInstruct': vd.LLaVAInstruct,
        'GromaInstruct': vd.GromaInstruct,
        # reference config type names (reference: groma/data/build.py:25-60)
        'coco_box': dd.ClassAgnosticCoco,
        'obj365_box': dd.ClassAgnosticCoco,
        'openimage_box': dd.ClassAgnosticCoco,
        'v3det_box': dd.ClassAgnosticCoco,
        'sa1b_box': dd.ClassAgnosticSA1B,
        'refcoco_rec': vd.RefCOCO,
        'refcoco_cap': vd.RefCOCOCap,
        'flickr30k': vd.Flickr30k,
        'single_vg': vd.SingleRoundVG,
        'multi_vg': vd.MultiRoundsVG,
        'coco': vd.COCODet,
        'lvis': vd.LVISDet,
        'grit': vd.Grit,
        'llava_instruct': vd.LLaVAInstruct,
        'groma_instruct': vd.GromaInstruct,
    })


class SubsetDataset:
    """ratio-subsampling (reference: build.py torch Subset with ratio)."""

    def __init__(self, base, ratio: float, seed: int = 0):
        self.base = base
        n = max(1, int(len(base) * ratio))
        rng = np.random.default_rng(seed)
        self.indices = rng.permutation(len(base))[:n]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[int(self.indices[i])]

    @property
    def source(self):
        return getattr(self.base, 'source', 'unknown')


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i):
        k = int(np.searchsorted(self.offsets, i, side='right') - 1)
        return self.datasets[k][i - int(self.offsets[k])]

    def source_of_index(self, i) -> str:
        k = int(np.searchsorted(self.offsets, i, side='right') - 1)
        return getattr(self.datasets[k], 'source', f'ds{k}')


def _merge_cfg(base: dict, override: dict) -> dict:
    """mmcv Config merge semantics: override wins; dicts merge recursively
    unless the override dict carries ``_delete_: True``
    (reference: mmcv/mmcv/utils/config.py:70 _merge_a_into_b)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict) \
                and not v.pop('_delete_', False):
            out[k] = _merge_cfg(out[k], v)
        else:
            out[k] = v
    return out


def load_config(cfg_file: str) -> dict:
    """Python-file config loader with mmcv ``_base_`` inheritance
    (reference: mmcv/mmcv/utils/config.py:70 Config.fromfile)."""
    spec = importlib.util.spec_from_file_location('dataset_config', cfg_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = {k: v for k, v in vars(mod).items() if not k.startswith('_')}

    bases = getattr(mod, '_base_', None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        for b in bases:
            bpath = os.path.join(os.path.dirname(
                os.path.abspath(cfg_file)), b)
            base_cfg = load_config(bpath)
            dup = set(merged) & set(base_cfg)
            if dup:
                raise KeyError(f'duplicate keys in _base_ files: {dup}')
            merged.update(base_cfg)
        cfg = _merge_cfg(merged, cfg)
    return cfg


def build_dataset(cfg: dict, **common):
    if not DATASETS:
        _register_builtin()
    cfg = dict(cfg)
    ratio = cfg.pop('ratio', None)
    ds_type = cfg.pop('type')
    ds = DATASETS[ds_type](**cfg, **common)
    if ratio is not None:
        ds = SubsetDataset(ds, ratio)
    return ds


def build_multi_datasets(cfg_file: str, **common) -> ConcatDataset:
    cfg = load_config(cfg_file)
    return ConcatDataset([build_dataset(c, **common)
                          for c in cfg['datasets']])


class SourceGroupedBatchSampler:
    """Every global batch comes from a single source dataset
    (reference: groma/train/groma_trainer.py:14-59 RandomBatchSampler:
    permute within each source, chunk into batches, permute batches).

    ``rank``/``world_size`` shard the deterministic global batch order
    across hosts (the DistributedSampler analogue, reference:
    HF Trainer's per-rank sampling under torchrun): every host computes
    the SAME seeded permutation and takes batches ``rank::world_size``,
    so multi-host input is deterministic with no coordination."""

    def __init__(self, dataset: ConcatDataset, batch_size: int,
                 seed: int = 0, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1):
        assert 0 <= rank < world_size, (rank, world_size)
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _global_len(self):
        n = 0
        for k in range(len(self.dataset.datasets)):
            sz = int(self.dataset.offsets[k + 1] - self.dataset.offsets[k])
            n += sz // self.batch_size if self.drop_last \
                else math.ceil(sz / self.batch_size)
        return n

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for k, ds in enumerate(self.dataset.datasets):
            lo, hi = int(self.dataset.offsets[k]), \
                int(self.dataset.offsets[k + 1])
            idx = rng.permutation(np.arange(lo, hi))
            nb = len(idx) // self.batch_size if self.drop_last \
                else math.ceil(len(idx) / self.batch_size)
            for b in range(nb):
                batches.append(idx[b * self.batch_size:
                                   (b + 1) * self.batch_size])
        order = rng.permutation(len(batches))
        # per-host shard: same global order everywhere, strided slice here
        # (ragged tail dropped so every host runs the same step count)
        n_even = (len(order) // self.world_size) * self.world_size
        for i in order[self.rank:n_even:self.world_size]:
            yield batches[i].tolist()

    def __len__(self):
        return self._global_len() // self.world_size


def collate_vl(samples: List[dict]) -> dict:
    """Stack fixed-shape VL samples into a device batch
    (replaces reference: groma/data/collator.py:9-37 — padding already
    happened host-side, so this is a pure stack)."""
    keys = ('images', 'input_ids', 'labels', 'region_slot', 'valid',
            'ground_boxes', 'ground_valid', 'refer_boxes', 'refer_valid')
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    batch['source'] = samples[0].get('source', '')
    return batch


def collate_det(samples: List[dict]) -> dict:
    """(replaces reference: groma/data/collator.py:41-62; asserts single
    source per batch like the reference's collator.py:47)."""
    sources = {s['source'] for s in samples}
    assert len(sources) == 1, 'det batches must be single-source'
    return {
        'images': np.stack([s['images'] for s in samples]),
        'targets': {
            k: np.stack([s['targets'][k] for s in samples])
            for k in ('class_labels', 'boxes', 'valid')},
        'source': sources.pop(),
    }
