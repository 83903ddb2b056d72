"""The PyTorch port imports without JAX (nor PIL, which the GPU machine
lacks: the data pipeline is imported inside the entry points), and its
chip smoke script refuses to run without a CUDA device."""

import ast
import os
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
        'groma_tpu_torch.serve.engine'} <= set(names), names
print(len(names), sorted(m for m in ('jax', 'flax', 'PIL')
                         if m in sys.modules))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    r = _run(['-c', IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    count, loaded = r.stdout.split(maxsplit=1)
    assert int(count) >= 28          # every module of the slices was imported
    assert loaded.strip() == '[]', f'port imported {loaded}'


def test_chip_smoke_fails_without_cuda():
    r = _run(['chip_smoke.py'], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout



def test_chip_smoke_imports_only_the_port():
    """The smoke script reaches the JAX package's jax-free host modules
    only through the port, and never imports jax itself."""
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split('.')[0])
    assert 'groma_tpu_torch' in roots
    assert not roots & {'groma_tpu', 'jax', 'jaxlib', 'flax', 'optax'}
