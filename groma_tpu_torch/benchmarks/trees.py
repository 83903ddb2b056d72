"""Two trees of the port in one run on one card: the driver of the
``ab_*.py`` scripts.

    python3 -m groma_tpu_torch.benchmarks.ab_probes --trees OLD NEW NEW OLD

Each tree (a checkout's root) runs in a process of its own, in the order
given (give the two trees in turns: old, new, new, old), with that tree's
``groma_tpu_torch`` first on the path and its kernels built there.  The
process runs the calling script's ``child(timer, args)`` from the script's
own file, with ``args`` parsed by the script's ``parser()`` and ``timer``
this tree's ``utils/profiling.Timer``: both trees run the same measurement
code, so a change of the timer cannot pose as a change of a tree.  The
child returns a dict, printed as one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()


def run_trees(script: str, trees, argv=()) -> list:
    """Runs ``script``'s child in each of ``trees`` in turn with the
    arguments ``argv`` (a list, or a function of the tree's root giving
    one); prints each run's JSON line and returns the runs' dicts, each
    with its 'tree'.  Exits naming the tree whose run failed."""
    name = Path(script).stem
    runs = []
    for tree in trees:
        root = os.path.abspath(tree)
        args = argv(root) if callable(argv) else list(argv)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             os.path.abspath(script), *args], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True)
        if proc.returncode != 0:
            sys.exit(f'{name}: the run of {tree} failed:\n'
                     f'{proc.stdout[-4000:]}{proc.stderr[-4000:]}')
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res['tree'] = tree
        print(f'{tree}: {json.dumps(res)}', flush=True)
        runs.append(res)
    return runs


def _child(script: str, argv) -> dict:
    """In the tree under test: ``script``'s child, with this file's tree's
    timer (a CUDA-event ``Timer``; None without a card)."""
    spec = importlib.util.spec_from_file_location(
        '_driver_profiling',
        Path(__file__).resolve().parents[1] / 'utils' / 'profiling.py')
    profiling = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiling)
    timer = (profiling.Timer('cuda')
             if profiling.torch.cuda.is_available() else None)
    ns = runpy.run_path(script)
    return ns['child'](timer, ns['parser']().parse_args(argv))


if __name__ == '__main__':
    print(json.dumps(_child(sys.argv[1], sys.argv[2:])), flush=True)
