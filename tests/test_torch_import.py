"""The PyTorch port stands alone: it imports without JAX, without PIL
(which the GPU machine lacks: the data pipeline is imported inside the
entry points) and without the JAX package, at any depth, also from a copy
of the tree that has no ``groma_tpu/``; and its chip smoke script refuses
to run without a CUDA device."""

import ast
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import groma_tpu_torch
names = [m.name for m in pkgutil.walk_packages(groma_tpu_torch.__path__,
                                               'groma_tpu_torch.')]
for name in names:
    importlib.import_module(name)
assert {'groma_tpu_torch.ops.quant4', 'groma_tpu_torch.ops.paged_attention',
        'groma_tpu_torch.serve.engine',
        'groma_tpu_torch.ops.decode_megakernel',
        'groma_tpu_torch.data.datasets.vl_datasets'} <= set(names), names
print(len(names), sorted(m for m in sys.modules
                         if m.split('.')[0] in ('jax', 'flax', 'PIL',
                                                'groma_tpu')
                         and '.' not in m))
"""


def _run(args, cwd, path=REPO):
    env = dict(os.environ, PYTHONPATH=path)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _port_files():
    for root, _, files in os.walk(os.path.join(REPO, 'groma_tpu_torch')):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def _imported_roots(path):
    """Top-level packages a file imports, at any depth (inside functions
    too)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
    return roots


def test_every_port_module_imports_without_jax():
    r = _run(['-c', IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    count, loaded = r.stdout.split(maxsplit=1)
    assert int(count) >= 48          # every module of the slices was imported
    assert loaded.strip() == '[]', f'port imported {loaded}'


def test_chip_smoke_fails_without_cuda():
    r = _run(['chip_smoke.py'], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_imports_only_the_port():
    """The smoke script imports the port and nothing of JAX or of the JAX
    package, at any depth."""
    roots = _imported_roots(os.path.join(REPO, 'chip_smoke.py'))
    assert 'groma_tpu_torch' in roots
    assert not roots & {'groma_tpu', 'jax', 'jaxlib', 'flax', 'optax'}


def test_no_port_file_imports_the_jax_package():
    """Every file of the port, and chip_smoke.py, scanned at every depth."""
    files = list(_port_files())
    assert len(files) > 40
    offenders = {os.path.relpath(p, REPO): sorted(roots)
                 for p in files
                 for roots in [_imported_roots(p)
                               & {'groma_tpu', 'jax', 'jaxlib', 'flax',
                                  'optax'}] if roots}
    assert not offenders, offenders


def test_port_runs_from_a_tree_without_the_jax_package(tmp_path):
    """A copy holding only the port, native/ (its image ops' C++ source)
    and chip_smoke.py: every module imports, and chip_smoke.py reaches its
    no-CUDA failure, not an import error."""
    for name in ('groma_tpu_torch', 'native'):
        shutil.copytree(os.path.join(REPO, name), tmp_path / name,
                        ignore=shutil.ignore_patterns('__pycache__', 'build'))
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    assert not (tmp_path / 'groma_tpu').exists()
    r = _run(['-c', IMPORT_ALL], str(tmp_path), path=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split(maxsplit=1)[1].strip() == '[]'
    r = _run(['chip_smoke.py'], str(tmp_path), path=str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout
    assert 'no CUDA device' in r.stderr, r.stderr
