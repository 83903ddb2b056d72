"""The nf4 codec, the bnb-nf4 import and the export CLI of the port against
the JAX package's.

* ``ops/quant4.nf4_quantize`` / ``nf4_dequantize``: codes, absmax and the
  dequantized values bitwise JAX's, on weights with zero blocks, exact
  table values and ties between two codes;
* ``checkpoint/hf_import.is_bnb_nf4`` / ``import_bnb_nf4_weight``: equal to
  JAX's on the bitsandbytes state dict that ``tests/test_quant4.py``
  builds (the shape from the quant_state blob and given), the same
  refusals;
* ``checkpoint/export_hf``: the tensors it writes, as one ``.safetensors``
  or as an HF directory (``config.json`` too), bitwise those of JAX's
  ``export_groma`` and of JAX's CLI on the same weights; its random
  weights load back through ``load_groma``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from groma_tpu.checkpoint import export_hf as j_export_hf
from groma_tpu.checkpoint import hf_import as j_import
from groma_tpu.checkpoint.hf_export import export_groma, export_hf_dir
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.ops.quant4 import NF4_TABLE as J_TABLE
from groma_tpu.ops.quant4 import nf4_dequantize as j_dequantize
from groma_tpu.ops.quant4 import nf4_quantize as j_quantize
from groma_tpu_torch.checkpoint import export_hf, hf_import
from groma_tpu_torch.ops.quant4 import (NF4_TABLE, nf4_dequantize,
                                        nf4_quantize)

CFG = tiny_groma_config()


def _weights(seed, shape):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = w.reshape(-1)
    flat[:64] = 0.0                              # an all-zero block
    flat[64:80] = NF4_TABLE                      # table values exactly
    flat[80] = 2.0                               # the block's absmax
    # midpoints between neighbouring codes (ties: the first code wins)
    flat[81:96] = (NF4_TABLE[:-1] + NF4_TABLE[1:]) / 2 * 2.0
    return w


def test_nf4_table_is_jaxs():
    np.testing.assert_array_equal(NF4_TABLE, J_TABLE)


@pytest.mark.parametrize('shape,block', [((32, 64), 64), ((48, 128), 64),
                                         ((16, 256), 128), ((4, 512), 256)])
def test_nf4_codes_and_values_are_jaxs_bit_for_bit(shape, block):
    w = _weights(sum(shape), shape)
    want = j_quantize(jnp.asarray(w), block=block)
    got = nf4_quantize(torch.from_numpy(w), block=block)
    assert got['codes'].dtype == torch.uint8
    np.testing.assert_array_equal(got['codes'].numpy(),
                                  np.asarray(want['codes']))
    np.testing.assert_array_equal(got['absmax'].numpy(),
                                  np.asarray(want['absmax']))
    assert (got['shape'], got['block']) == (tuple(want['shape']),
                                            want['block'])
    np.testing.assert_array_equal(nf4_dequantize(got).numpy(),
                                  np.asarray(j_dequantize(want)))


def test_nf4_refuses_a_ragged_weight():
    with pytest.raises(ValueError):
        nf4_quantize(torch.zeros(3, 7), block=64)


def _bnb_state_dict(seed=0):
    """The bitsandbytes 0.43 serialization of one nf4 Linear4bit weight, as
    tests/test_quant4.py builds it."""
    w = np.random.default_rng(seed).standard_normal((32, 64)).astype(
        np.float32)
    qd = j_quantize(jnp.asarray(w), block=64)
    meta = json.dumps({'shape': [32, 64], 'blocksize': 64,
                       'dtype': 'float32', 'quant_type': 'nf4'}).encode()
    name = 'llm.layers.0.q_proj.weight'
    return name, {
        name: np.asarray(qd['codes']).reshape(-1, 1),
        f'{name}.absmax': np.asarray(qd['absmax']),
        f'{name}.quant_map': J_TABLE.copy(),
        f'{name}.quant_state.bitsandbytes__nf4': np.frombuffer(meta,
                                                               np.uint8),
    }


def test_bnb_nf4_import_is_jaxs():
    name, sd = _bnb_state_dict()
    for key in (name, 'llm.layers.0.k_proj.weight'):
        assert hf_import.is_bnb_nf4(sd, key) == j_import.is_bnb_nf4(sd, key)
    assert hf_import.is_bnb_nf4(sd, name)
    no_blob = {k: v for k, v in sd.items() if 'quant_state' not in k}
    assert hf_import.is_bnb_nf4(no_blob, name)
    want = j_import.import_bnb_nf4_weight(sd, name)
    got = hf_import.import_bnb_nf4_weight(sd, name)
    assert got.dtype == np.float32 and got.shape == (32, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        hf_import.import_bnb_nf4_weight(no_blob, name, shape=(32, 64)),
        j_import.import_bnb_nf4_weight(no_blob, name, shape=(32, 64)))
    with pytest.raises(ValueError, match='shape'):
        hf_import.import_bnb_nf4_weight(no_blob, name)
    sd[f'{name}.nested_absmax'] = np.zeros(2, np.float32)
    with pytest.raises(NotImplementedError):
        hf_import.import_bnb_nf4_weight(sd, name)


def test_bnb_import_refuses_another_quant_map():
    name, sd = _bnb_state_dict()
    sd[f'{name}.quant_map'] = np.linspace(-1, 1, 16).astype(np.float32)
    with pytest.raises(AssertionError):
        hf_import.import_bnb_nf4_weight(sd, name)


@pytest.fixture(scope='module')
def jax_checkpoint(tmp_path_factory):
    model = JGroma(CFG)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                        **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    d = str(tmp_path_factory.mktemp('export') / 'jax_ckpt')
    export_hf_dir(params, CFG, d)
    return params, d


def _run_jax_cli(monkeypatch, ckpt, out):
    monkeypatch.setattr(sys, 'argv', ['export_hf', '--ckpt', ckpt,
                                      '--out', out])
    j_export_hf.main()


def test_export_file_is_jaxs(jax_checkpoint, tmp_path, monkeypatch):
    params, ckpt = jax_checkpoint
    out = str(tmp_path / 'port.safetensors')
    export_hf.main(['--ckpt', ckpt, '--out', out])
    got = load_file(out)
    want = export_groma(params, CFG)
    _run_jax_cli(monkeypatch, ckpt, str(tmp_path / 'jax.safetensors'))
    from_cli = load_file(str(tmp_path / 'jax.safetensors'))
    assert got.keys() == want.keys() == from_cli.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], from_cli[k], err_msg=k)


def test_export_directory_is_jaxs(jax_checkpoint, tmp_path, monkeypatch):
    _, ckpt = jax_checkpoint
    export_hf.main(['--ckpt', ckpt, '--out', str(tmp_path / 'port')])
    _run_jax_cli(monkeypatch, ckpt, str(tmp_path / 'jax'))
    for d in ('port', 'jax'):
        assert sorted(os.listdir(tmp_path / d)) == ['config.json',
                                                    'model.safetensors']
    with open(tmp_path / 'port' / 'config.json') as f, \
            open(tmp_path / 'jax' / 'config.json') as g:
        assert json.load(f) == json.load(g)
    got = load_file(str(tmp_path / 'port' / 'model.safetensors'))
    want = load_file(str(tmp_path / 'jax' / 'model.safetensors'))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_export_of_random_weights_loads_back(tmp_path):
    from groma_tpu_torch.checkpoint.loader import load_groma
    sd = export_hf.main(['--ckpt', 'tiny', '--out', str(tmp_path / 'tiny')])
    model, cfg = load_groma(str(tmp_path / 'tiny'), 'cpu',
                            full_precision=True)
    assert cfg.to_dict() == CFG.to_dict()
    back = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
