"""The A/B driver of the ``ab_*.py`` scripts (``benchmarks/trees.py``) on
the CPU: each tree runs the calling script's child in a process of its
own, with that tree's ``groma_tpu_torch`` first on the path, in the order
given, and a failed run stops the driver naming its tree.  The children
of the real scripts need a card; here a script of the same form stands in,
and its child is handed no timer."""

import textwrap

import pytest

from groma_tpu_torch.benchmarks import trees

SCRIPT = '''
import argparse


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trees', nargs='+')
    ap.add_argument('--seed', type=int, default=0)
    return ap


def child(timer, args):
    import groma_tpu_torch
    if groma_tpu_torch.NAME == 'broken':
        raise RuntimeError('this tree cannot run')
    return {'name': groma_tpu_torch.NAME, 'seed': args.seed,
            'timer': timer is not None}
'''


def _tree(root, name):
    pkg = root / name / 'groma_tpu_torch'
    pkg.mkdir(parents=True)
    (pkg / '__init__.py').write_text(f'NAME = {name!r}\n')
    return str(root / name)


def test_each_tree_runs_the_scripts_child_on_its_own_package(tmp_path,
                                                             capsys):
    script = tmp_path / 'ab_fake.py'
    script.write_text(textwrap.dedent(SCRIPT))
    old, new = _tree(tmp_path, 'old'), _tree(tmp_path, 'new')
    seeds = iter(['1', '2', '3'])
    runs = trees.run_trees(str(script), [old, new, old],
                           lambda root: ['--seed', next(seeds)])
    assert [(r['name'], r['seed'], r['tree']) for r in runs] == [
        ('old', 1, old), ('new', 2, new), ('old', 3, old)]
    assert not any(r['timer'] for r in runs)       # no card here
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in printed] == [old, new, old]


def test_a_failed_run_stops_the_driver_naming_its_tree(tmp_path):
    script = tmp_path / 'ab_fake.py'
    script.write_text(textwrap.dedent(SCRIPT))
    broken = _tree(tmp_path, 'broken')
    with pytest.raises(SystemExit, match=f'ab_fake: the run of {broken} '
                                         'failed:(.|\n)*cannot run'):
        trees.run_trees(str(script), [broken], ['--seed', '0'])
