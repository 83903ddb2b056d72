"""engine.launch_ms_per_step.<cell>: the host's time in the decode bursts'
graph launches per decode step, from the window's opening to the
trace's: differences of the engine's ``stats()`` counters
``launch_sec`` and ``decode_steps`` at those two times."""


def read(ctx):
    a, b = ctx.run.stats_open, ctx.run.stats_trace[0]
    steps = b['decode_steps'] - a['decode_steps']
    if a.get('launch_sec') is None or b.get('launch_sec') is None \
            or steps <= 0:
        return None
    return 1e3 * (b['launch_sec'] - a['launch_sec']) / steps
