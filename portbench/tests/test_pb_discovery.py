"""A cell, a configuration and a per-layer metric added as new files in a
copy of the benchmark are found by name and run, and no file that was
there changes."""

from __future__ import annotations

import hashlib
import json

from portbench import run
from portbench.tests.conftest import TINY_SPEC, tiny_root

READER = '''
def read(ctx):
    return float(len(ctx.run.records))
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / 'portbench').rglob('*') if p.is_file()}


def test_new_files_are_found_and_run(tmp_path, capsys):
    root = tiny_root(tmp_path)
    before = _digests(root)
    pb = root / 'portbench'
    (pb / 'configs' / 'tiny-b.json').write_text(json.dumps(TINY_SPEC))
    wl = json.loads((pb / 'workloads' / 'tiny.closed.json').read_text())
    wl['config'] = 'tiny-b'
    wl['traffic']['arrivals'] = {'kind': 'poisson', 'rate': 6.0,
                                 'lead_s': 0.5}
    (pb / 'workloads' / 'tiny-b.bursty.json').write_text(json.dumps(wl))
    (pb / 'metrics' / 'requests_seen.py').write_text(READER)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny-b', 'source': 'tests',
                             'file': 'portbench/configs/tiny-b.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': 'tiny-b.bursty', 'config': 'tiny-b',
                               'traffic': 'bursty', 'chips': 1,
                               'why': 'test'})
    bench['per_layer'].append({'name': 'requests_seen.bursty', 'unit': 'n',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'load generator',
                               'moves': 'ttft_p90_ms',
                               'workloads': ['tiny-b.bursty']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    rc = run.main(['--workload', 'tiny-b.bursty', '--seed', '99',
                   '--seconds', '2', '--trace', '1'], device='cpu', root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['metrics']['requests_seen.bursty']['value'] > 0
    assert out['correct'], out['checks']
    after = _digests(root)
    assert {p: d for p, d in after.items() if p in before} == before
