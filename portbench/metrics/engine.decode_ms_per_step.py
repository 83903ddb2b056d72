"""engine.decode_ms_per_step.<cell>: the engine's mean wall time of one
decode step from the window's opening to the trace's, from the
differences of its ``stats()`` counters (``decode_steps`` and
``decode_ms_per_step`` times it) at those two times."""


def read(ctx):
    a, b = ctx.run.stats_open, ctx.run.stats_trace[0]
    steps = b['decode_steps'] - a['decode_steps']
    if steps <= 0:
        return None
    ms = ((b['decode_ms_per_step'] or 0.0) * b['decode_steps']
          - (a['decode_ms_per_step'] or 0.0) * a['decode_steps'])
    return ms / steps
