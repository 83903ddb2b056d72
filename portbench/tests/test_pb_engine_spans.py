"""The readers of the engine's spans and counters: each gives its known
value on a made-up run, and None where the run has nothing to read (no
steps, no requests in the range, a program without the spans); every
such metric of ``BENCHMARK.json`` finds its reader; and a traced tiny
run on the CPU reports the counter readers and leaves the device ones
out (there is no device clock)."""

from __future__ import annotations

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests.conftest import tiny_root

ROOT = Path(__file__).resolve().parent.parent.parent
COUNTERS = ('engine.admit_stall_pct.caption',
            'engine.launch_ms_per_step.caption',
            'engine.queue_wait_ms_p90.refer', 'engine.admit_ms.refer')
DEVICE = ('engine.device_ms_per_step.caption',
          'engine.vision_device_ms.refer',
          'engine.llm_prefill_device_ms.refer')
SEED = 2**31 + 2727


def _read(name, ctx):
    return run.metric_reader(ROOT, name).read(ctx)


def _stats(steps, **sums):
    return {'decode_steps': steps, 'decode_ms_per_step': 7.0,
            'tokens_emitted': 0, 'max_slots': 8, **sums}


def _session(submit, admit, first, vision=None, llm=None):
    return SimpleNamespace(
        t_submit=submit, t_admit=admit, t_first=first,
        prefill_device_ms=None if vision is None
        else {'vision': vision, 'llm': llm})


def _ctx(records=(), open_=None, before=None, t0=100.0, t_pre=150.0):
    r = SimpleNamespace(stats_open=open_ or _stats(0),
                        stats_trace=(before or _stats(0), None),
                        t0=t0, t_pre=t_pre, records=list(records))
    return SimpleNamespace(run=r)


def _record(due, session):
    return SimpleNamespace(due=due, session=session)


def test_counter_readers_give_their_differences():
    a = _stats(800, stall_sec=3.0, launch_sec=0.2, decode_device_sec=5.0)
    b = _stats(6400, stall_sec=28.0, launch_sec=1.6,
               decode_device_sec=45.0)
    ctx = _ctx(open_=a, before=b)
    assert _read('engine.admit_stall_pct.caption', ctx) == \
        pytest.approx(100.0 * 25.0 / 50.0)
    assert _read('engine.launch_ms_per_step.caption', ctx) == \
        pytest.approx(1e3 * 1.4 / 5600)
    assert _read('engine.device_ms_per_step.caption', ctx) == \
        pytest.approx(1e3 * 40.0 / 5600)


def test_counter_readers_without_data_give_none():
    old = _stats(800)                 # a program without the counters
    assert all(_read(n, _ctx(open_=old, before=_stats(6400))) is None
               for n in COUNTERS[:2] + DEVICE[:1])
    still = _stats(800, stall_sec=1.0, launch_sec=0.1,
                   decode_device_sec=None)
    ctx = _ctx(open_=still, before=still)       # no step in the range
    assert _read('engine.launch_ms_per_step.caption', ctx) is None
    assert _read('engine.device_ms_per_step.caption', ctx) is None
    cpu = _stats(900, stall_sec=2.0, launch_sec=0.2, decode_device_sec=None)
    assert _read('engine.device_ms_per_step.caption',
                 _ctx(open_=still, before=cpu)) is None
    assert _read('engine.admit_stall_pct.caption',
                 _ctx(open_=still, before=cpu, t_pre=100.0)) is None


def test_session_readers_give_their_known_values():
    recs = [_record(100.0 + i, _session(100.0 + i, 100.0 + i + 0.01 * i,
                                        100.0 + i + 0.01 * i + 0.2,
                                        vision=40.0 + i, llm=100.0 + i))
            for i in range(10)]
    # due before the window, admitted inside it; due after the range
    recs.append(_record(99.0, _session(99.0, 100.5, 100.7, 50.0, 110.0)))
    recs.append(_record(151.0, _session(151.0, 151.0, 151.2, 1.0, 1.0)))
    ctx = _ctx(recs)
    waits = sorted(10.0 * i for i in range(10))
    p90 = waits[8] + 0.1 * (waits[9] - waits[8])
    assert _read('engine.queue_wait_ms_p90.refer', ctx) == pytest.approx(p90)
    assert _read('engine.admit_ms.refer', ctx) == pytest.approx(200.0)
    assert _read('engine.vision_device_ms.refer', ctx) == \
        pytest.approx((sum(40.0 + i for i in range(10)) + 50.0) / 11)
    assert _read('engine.llm_prefill_device_ms.refer', ctx) == \
        pytest.approx((sum(100.0 + i for i in range(10)) + 110.0) / 11)


def test_a_request_never_admitted_waits_forever():
    recs = [_record(100.0 + i, _session(100.0 + i, 100.0 + i, 100.2 + i))
            for i in range(5)]
    recs += [_record(120.0, _session(120.0, None, None)),
             _record(121.0, None)]                   # submit refused
    assert math.isinf(_read('engine.queue_wait_ms_p90.refer', _ctx(recs)))
    assert _read('engine.admit_ms.refer', _ctx(recs)) == \
        pytest.approx(200.0)


def test_session_readers_without_data_give_none():
    assert all(_read(n, _ctx()) is None for n in COUNTERS[2:] + DEVICE[1:])
    old = SimpleNamespace(t_submit=1.7e9, t_first=1.7e9 + 0.3)   # no spans
    ctx = _ctx([_record(120.0, old)])
    assert all(_read(n, ctx) is None for n in COUNTERS[2:] + DEVICE[1:])
    cpu = [_record(120.0, _session(120.0, 120.1, 120.3))]   # no device
    assert _read('engine.vision_device_ms.refer', _ctx(cpu)) is None
    assert _read('engine.llm_prefill_device_ms.refer', _ctx(cpu)) is None


def test_every_span_metric_finds_its_reader():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    names = {m['name']: m for m in bench['per_layer']}
    for name in COUNTERS + DEVICE:
        m = names[name]
        assert m['source'] == 'program_counter' and len(m['workloads']) == 1
        reader = run.metric_reader(ROOT, name)
        assert Path(reader.__file__).name == \
            name.rsplit('.', 1)[0] + '.py'


@pytest.mark.parametrize('kind', ['closed', 'poisson'])
def test_traced_tiny_run_reports_the_counter_readers(tmp_path, capsys, kind):
    root = tiny_root(tmp_path, kinds=(kind,))
    rc = run.main(['--workload', f'tiny.{kind}', '--seed', str(SEED),
                   '--seconds', '5', '--trace', '1'], device='cpu',
                  root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['correct'], out['checks']
    got = out['metrics']
    for name in COUNTERS:
        assert name in got, name
    assert not any(name in got for name in DEVICE)
    assert got['engine.admit_ms.refer']['value'] > 0
    assert 0 <= got['engine.admit_stall_pct.caption']['value'] <= 100
