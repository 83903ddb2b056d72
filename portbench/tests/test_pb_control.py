"""The control: the plain reference put in the program's place one
precision step down (every product's input in fp8, the KV cache in int4),
read over the same prompts and served tokens, must come out as not
correct against the cell's limit, while the program stays inside it.

On the CPU at the tiny size (the look for a card skipped), and on the
card at each serving cell's own size on three seeds (``card``)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.conftest import tiny_root

ROOT = Path(__file__).resolve().parent.parent.parent
SERVING = ('groma-ds7b-int4.caption-batch', 'groma-ds7b-int4.refer-poisson')


def readings(root: Path, cell: str, seed: int, seconds: float, device):
    """One short window of ``cell`` and the check with the control:
    (the readings, the cell's limits)."""
    plan = run.cell_plan(root, cell)
    driver = run.load_module(
        root / 'portbench' / 'drivers' / f"{plan.workload['driver']}.py",
        'portbench_driver_control')
    system = driver.setup(plan.spec, plan.workload, seed, device)
    window = driver.window(system, seconds)
    driver.release(system)
    got = driver.check(system, window, seed, device, control=True)
    return got, plan.workload['check']['limits']


def test_control_fails_at_the_tiny_size(tmp_path):
    got, limits = readings(tiny_root(tmp_path), 'tiny.closed', 31337, 2.0,
                           'cpu')
    assert got['logit_gap'] <= limits['logit_gap']
    assert got['control_gap'] > limits['logit_gap'], got


@pytest.mark.card
@pytest.mark.parametrize('seed', [2**31 + 7, 2**31 + 8, 2**31 + 9])
@pytest.mark.parametrize('cell', [
    c for c in SERVING if c in (ROOT / 'BENCHMARK.json').read_text()])
def test_control_fails_at_the_cells_size(card, cell, seed):
    got, limits = readings(ROOT, cell, seed, 8.0, 'cuda')
    print(json.dumps({'cell': cell, 'seed': seed, 'card': card, **got}))
    assert got['logit_gap'] <= limits['logit_gap']
    assert got['control_gap'] > limits['logit_gap'], got
