"""The check catches a broken timed path: the harness runs a tiny cell
on the CPU (the look for a card skipped) with a fault planted in the
program underneath, and ``correct`` comes out false.  The faults a
serving cell can have: a token altered where it is produced, and a
decode step that returns its state unchanged (its KV write lost)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.tests.conftest import tiny_root

SEED = 2**31 + 12345


def _result(capsys, root, cell='tiny.closed', trace=0, seconds=2):
    rc = run.main(['--workload', cell, '--seed', str(SEED), '--seconds',
                   str(seconds),
                   '--trace', str(trace)], device='cpu', root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(tmp_path, capsys):
    out = _result(capsys, tiny_root(tmp_path))
    assert out['correct'], out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0
    assert list(out)[-1] == 'checks'


def test_altered_token_is_caught(tmp_path, capsys, monkeypatch):
    from groma_tpu_torch.serve.engine import BatchEngine
    pick = BatchEngine._pick

    def altered(self, logits, temps, sample):
        return (pick(self, logits, temps, sample) + 1) % logits.shape[-1]
    monkeypatch.setattr(BatchEngine, '_pick', altered)
    out = _result(capsys, tiny_root(tmp_path))
    assert not out['correct']
    assert out['checks']['logit_gap']['value'] > \
        out['checks']['logit_gap']['limit']


def test_step_that_keeps_its_state_is_caught(tmp_path, capsys, monkeypatch):
    import groma_tpu_torch.serve.engine as engine
    decode = engine.quant_llama_decode_paged

    def unchanged(qp, cfg, emb, pos, pools, table, lengths):
        kept = {k: [t.clone() for t in v] for k, v in pools.items()}
        hidden, _ = decode(qp, cfg, emb, pos, kept, table, lengths)
        return hidden, pools
    monkeypatch.setattr(engine, 'quant_llama_decode_paged', unchanged)
    out = _result(capsys, tiny_root(tmp_path))
    assert not out['correct']


@pytest.mark.parametrize('kind', ['closed', 'poisson'])
def test_traced_run_reports_the_per_layer_metrics(tmp_path, capsys, kind):
    out = _result(capsys, tiny_root(tmp_path, kinds=(kind,)), f'tiny.{kind}',
                  trace=1, seconds=5)
    assert out['correct'], out['checks']
    dev = out['device']
    assert dev['window_s'] > 0 and 0 <= dev['busy_s'] <= dev['window_s']
    for name in ('engine.decode_ms_per_step.caption', 'idle_pct.caption',
                 'mfu.caption'):
        assert name in out['metrics']
    assert len(out['breakdown']['idle_gaps']) <= 10
    assert torch.cuda.is_available() or dev['platform'] == 'cpu'
