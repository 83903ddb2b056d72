"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Everything about a cell is found by name:
its entry in ``BENCHMARK.json`` (configuration, chips, metrics), its
traffic and its limits in ``portbench/workloads/<cell>.json``, the
configuration's file as ``BENCHMARK.json`` names it, the driver that
runs it in ``portbench/drivers/<driver>.py``, and each per-layer metric's
reader in ``portbench/metrics/<metric>.py`` (or, for a metric named
``<base>.<suffix>``, the reader of the longest prefix that has a file).

A run: set-up (weights from the seed, the system, the warm-up), then the
measured window of ``--seconds``, then, once the program's state is
freed, the comparison with the plain reference that decides ``correct``.
With ``--trace 1`` the profiler covers ``TRACE_SECONDS`` in the middle of
the window and the per-layer metrics are reported; with ``--trace 0`` the
end-to-end ones.  The last line of standard output is the result, one
JSON object; the numbers compared stand, each beside its limit, as the
last lines of standard error and under the result's last key, 'checks'.

The run refuses (exit 2, no result) without a CUDA device or with fewer
than the cell's chips, and fails (exit 3, no result) when JAX or the JAX
package is loaded in this process once the window, the readers and the
check are done: the look comes just before the result is printed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'groma_tpu')
TRACE_SECONDS = 2.0


def process_start() -> float:
    """This process's start, on the ``time.time`` clock (from /proc)."""
    ticks = os.sysconf('SC_CLK_TCK')
    with open('/proc/self/stat') as f:
        start = int(f.read().rsplit(')', 1)[1].split()[19]) / ticks
    with open('/proc/stat') as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith('btime'))
    return boot + start


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """The reader of metric ``name``: metrics/<name>.py, or that of the
    longest dotted prefix of the name that has a file."""
    parts = name.split('.')
    for n in range(len(parts), 0, -1):
        path = root / 'portbench' / 'metrics' / ('.'.join(parts[:n]) + '.py')
        if path.is_file():
            return load_module(path, 'portbench_metric_' +
                               '_'.join(parts[:n]).replace('-', '_'))
    raise FileNotFoundError(f'no reader for metric {name!r}')


def cell_plan(root: Path, cell: str) -> SimpleNamespace:
    """What ``BENCHMARK.json`` and the cell's files say about ``cell``."""
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    entry = next((w for w in bench['workloads'] if w['name'] == cell), None)
    if entry is None:
        raise SystemExit(f'no workload {cell!r} in BENCHMARK.json')
    config = next(c for c in bench['configs'] if c['name'] == entry['config'])

    def mine(metrics):
        return [m for m in metrics if cell in m.get('workloads', [cell])]
    workload = json.loads(
        (root / 'portbench' / 'workloads' / f'{cell}.json').read_text())
    return SimpleNamespace(
        cell=cell, chips=entry['chips'], end_to_end=mine(bench['end_to_end']),
        per_layer=mine(bench['per_layer']), workload=workload,
        spec=json.loads((root / config['file']).read_text()))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``groma_tpu_torch`` is not ``groma_tpu``)."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    """The card's power limit (W) as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits'],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def set_cache_dirs(root: Path):
    """Every kernel cache at a fixed path inside the checkout."""
    cache = root / '.portbench_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'


def finite(x):
    """``x``, or None where it is missing or not a finite number (the
    result line is strict JSON)."""
    return x if x is not None and math.isfinite(x) else None


def judge(readings: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number the workload limits."""
    out = []
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value <= limit
        out.append((name, value, limit, ok))
    return out


def main(argv=None, device=None, root: Path = PACKAGE.parent) -> int:
    """One run from the checkout at ``root``; ``device`` None looks for
    the card (a test passes 'cpu' and skips the look)."""
    t_start = process_start()
    ap = argparse.ArgumentParser(description='run one benchmark cell once')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    plan = cell_plan(root, args.workload)

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < plan.chips:
            print(f'refused: cell {plan.cell} needs {plan.chips} CUDA '
                  f'device(s), found '
                  f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
                  file=sys.stderr)
            return 2
        device = 'cuda'
    set_cache_dirs(root)
    driver = load_module(
        root / 'portbench' / 'drivers' / f"{plan.workload['driver']}.py",
        'portbench_driver_' + plan.workload['driver'])
    watts = power_limit() if device == 'cuda' else None

    system = driver.setup(plan.spec, plan.workload, args.seed, device)
    trace = None
    if args.trace:
        from portbench.trace import Trace
        trace = Trace()
    run = driver.window(system, args.seconds, trace,
                        min(TRACE_SECONDS, args.seconds))
    setup_s = (time.time() - (time.perf_counter() - run.t0)) - t_start

    metrics = {}
    if args.trace:
        red = trace.reduce()
        ctx = SimpleNamespace(run=run, trace=red, spec=plan.spec,
                              workload=plan.workload, t_open=trace.t_open,
                              t_close=trace.t_close)
        for m in plan.per_layer:
            value = finite(metric_reader(root, m['name']).read(ctx))
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = driver.end_to_end(run)
        e2e['setup_s'] = setup_s
        for m in plan.end_to_end:
            if finite(e2e.get(m['name'])) is not None:
                metrics[m['name']] = {'value': e2e[m['name']],
                                      'unit': m['unit']}
    attempted, failed = driver.counts(run)
    dev = {'platform': 'gpu' if device == 'cuda' else 'cpu',
           'kind': torch.cuda.get_device_name(0) if device == 'cuda'
           else 'cpu', 'count': plan.chips,
           'memory_peak_bytes': torch.cuda.max_memory_allocated()
           if device == 'cuda' else 0, 'power_limit_w': watts}
    if args.trace:
        dev['busy_s'] = red['busy_s']
        dev['window_s'] = red['window_s']

    driver.release(system)
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    readings = driver.check(system, run, args.seed, device)
    checks = judge(readings, plan.workload['check']['limits'])
    correct = failed == 0 and all(ok for *_, ok in checks)
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev}
    if args.trace:
        result['breakdown'] = {'device_ops': red['device_ops'],
                               'idle_gaps': red['idle_gaps']}
    result['checks'] = {n: {'value': finite(v), 'limit': lim}
                        for n, v, lim, _ in checks}
    # last, after every reader and the reference have been loaded
    bad = forbidden_modules()
    if bad:
        print(f'refused: the process loaded {", ".join(bad)}',
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    for n, v, lim, ok in checks:
        print(f'check {n}: {v} (limit {lim}) {"ok" if ok else "FAILED"}',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
