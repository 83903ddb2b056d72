"""The PyTorch port imports without JAX, and its chip smoke script refuses
to run without a CUDA device."""

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
print(len(names), sorted(m for m in ('jax', 'flax') if m in sys.modules))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    r = _run(['-c', IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    count, loaded = r.stdout.split(maxsplit=1)
    assert int(count) >= 20          # every module of the slice was imported
    assert loaded.strip() == '[]', f'port imported {loaded}'


def test_chip_smoke_fails_without_cuda():
    r = _run(['chip_smoke.py'], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

