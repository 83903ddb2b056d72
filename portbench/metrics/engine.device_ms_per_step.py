"""engine.device_ms_per_step.<cell>: the device's time in the decode
bursts per decode step, from the window's opening to the trace's:
differences of the engine's ``stats()`` counters ``decode_device_sec``
(timing events around each burst's replays) and ``decode_steps`` at
those two times."""


def read(ctx):
    a, b = ctx.run.stats_open, ctx.run.stats_trace[0]
    steps = b['decode_steps'] - a['decode_steps']
    if a.get('decode_device_sec') is None \
            or b.get('decode_device_sec') is None or steps <= 0:
        return None
    return 1e3 * (b['decode_device_sec'] - a['decode_device_sec']) / steps
