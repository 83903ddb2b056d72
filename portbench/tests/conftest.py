"""Tests of the benchmark.  CPU tests drive the harness at a tiny size
with the card's look skipped; tests that need the card carry the
``card`` marker and skip, by a fixture, where there is none."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent

TINY_MODEL = {
    "llm": {"hidden_size": 256, "intermediate_size": 768,
            "num_hidden_layers": 2, "num_attention_heads": 2,
            "num_key_value_heads": 2, "max_position_embeddings": 512,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-06, "vocab_size": 512},
    "llm_dtype": "bfloat16",
    "vit": {"hidden_size": 32, "num_layers": 4, "num_heads": 4,
            "mlp_ratio": 4.0, "patch_size": 14, "image_size": 56,
            "num_channels": 3, "layerscale_value": 1.0,
            "layer_norm_eps": 1e-06, "use_swiglu_ffn": False,
            "dtype": "float32"},
    "ddetr": {"d_model": 32, "num_queries": 12, "encoder_layers": 2,
              "decoder_layers": 2, "num_heads": 4, "ffn_dim": 64,
              "num_feature_levels": 1, "enc_n_points": 4, "dec_n_points": 4,
              "num_labels": 1, "two_stage": True, "with_box_refine": True,
              "dtype": "float32"},
    "image_size": 56, "num_image_tokens": 4, "num_new_token": 114,
    "max_region_num": 8, "max_seq_len": 256, "nms_thres": 0.6,
    "box_score_thres": 0.15, "region_roi_out": 4, "region_num_fuse": 2,
    "region_gn_groups": 8}

TINY_SPEC = {
    "source": "tests", "reduced": [], "model": TINY_MODEL,
    "deployment": {"engine_slots": 2, "quant_type": "int4", "kv_bits": 8,
                   "paged_kv": True, "max_new_tokens": 16, "chunk": 4}}

TINY_TRAFFIC = {
    "closed": {"arrivals": {"kind": "closed", "clients": 3}, "pool": 16,
               "instruction_tokens": [4, 12],
               "answer": {"law": "lognormal", "median": 8, "sigma": 0.5,
                          "min": 4, "max": 16}},
    "poisson": {"arrivals": {"kind": "poisson", "rate": 8.0, "lead_s": 0.5},
                "pool": 48, "instruction_tokens": [4, 12],
                "answer": {"law": "uniform", "min": 4, "max": 8}}}

TINY_LIMITS = {"logit_gap": 0.05, "nms_overlap": 0}


def tiny_root(tmp_path: Path, kinds=('closed',), limits=None) -> Path:
    """A checkout-like directory: a copy of the benchmark with a tiny
    configuration, one tiny cell per traffic kind, and a BENCHMARK.json
    naming them (every metric of the real file, for the cells whose
    kind reports it)."""
    root = tmp_path / 'checkout'
    shutil.copytree(PORTBENCH, root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (root / 'portbench' / 'configs' / 'tiny.json').write_text(
        json.dumps(TINY_SPEC))
    real = json.loads((PORTBENCH.parent / 'BENCHMARK.json').read_text())
    cells = []
    for kind in kinds:
        name = f'tiny.{kind}'
        (root / 'portbench' / 'workloads' / f'{name}.json').write_text(
            json.dumps({"config": "tiny", "driver": "engine",
                        "traffic": TINY_TRAFFIC[kind],
                        "check": {"min_tokens": 24, "max_requests": 4,
                                  "limits": limits or TINY_LIMITS}}))
        cells.append({"name": name, "config": "tiny", "traffic": kind,
                      "chips": 1, "why": "test"})
    bench = {**real, "configs": [{"name": "tiny", "source": "tests",
                                  "file": "portbench/configs/tiny.json",
                                  "reduced": [], "why": "test"}],
             "workloads": cells}
    for key in ('end_to_end', 'per_layer'):
        bench[key] = [{k: v for k, v in m.items() if k != 'workloads'}
                      for m in real[key]]
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA H100; skipped where there is none')


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.cuda.get_device_name(0)
