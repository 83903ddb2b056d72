"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level name (so ``groma_tpu_torch`` is not ``groma_tpu``), and
the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.conftest import tiny_root

PORTBENCH = Path(__file__).resolve().parent.parent


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def _modules(under: Path) -> list:
    return sorted(under.rglob('*.py'))


@pytest.mark.parametrize('path', _modules(PORTBENCH),
                         ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize('path', _modules(PORTBENCH / 'reference'),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {'groma_tpu_torch', 'groma_tpu'}


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, 'groma_tpu_torch_extra',
                        types.ModuleType('groma_tpu_torch_extra'))
    assert 'groma_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'groma_tpu.config',
                        types.ModuleType('groma_tpu.config'))
    assert run.forbidden_modules() == ['groma_tpu']


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'groma-ds7b-int4.caption-batch', '--seed',
                   '1', '--seconds', '1'])
    assert rc == 2
    assert capsys.readouterr().out == ''


PLANTED = '''
import sys
import types
sys.modules.setdefault('flax', types.ModuleType('flax'))


def read(ctx):
    return 1.0
'''


def test_a_reader_that_loads_jax_stops_the_result(tmp_path, capsys):
    """A per-layer reader, loaded after the window has closed, that
    brings in a forbidden module: exit 3 and no result line."""
    root = tiny_root(tmp_path)
    (root / 'portbench' / 'metrics' / 'planted.py').write_text(PLANTED)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append({'name': 'planted.caption', 'unit': 'n',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'load generator',
                               'moves': 'output_tok_per_s'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert 'flax' not in sys.modules
    try:
        rc = run.main(['--workload', 'tiny.closed', '--seed', '5',
                       '--seconds', '2', '--trace', '1'], device='cpu',
                      root=root)
        assert 'flax' in sys.modules
    finally:
        sys.modules.pop('flax', None)
    out = capsys.readouterr()
    assert rc == 3
    assert out.out.strip() == ''
    assert 'flax' in out.err
