"""engine.admit_stall_pct.<cell>: the share of the time from the window's
opening to the trace's in which admissions held the live streams still:
the difference of the engine's ``stats()['stall_sec']`` at those two
times over their distance."""


def read(ctx):
    run = ctx.run
    a, b = run.stats_open, run.stats_trace[0]
    if a.get('stall_sec') is None or b.get('stall_sec') is None \
            or run.t_pre <= run.t0:
        return None
    return 100.0 * (b['stall_sec'] - a['stall_sec']) / (run.t_pre - run.t0)
