"""engine.slot_occupancy.<cell>: the share of slot-steps that decoded a
token for a client, from the window's opening to the trace's: tokens
emitted by decode steps (all tokens emitted less the first tokens, which
come from prefills) over decode steps times ``max_slots``."""


def read(ctx):
    run = ctx.run
    a, b = run.stats_open, run.stats_trace[0]
    steps = b['decode_steps'] - a['decode_steps']
    if steps <= 0:
        return None
    emitted = b['tokens_emitted'] - a['tokens_emitted']
    firsts = sum(1 for r in run.records
                 if r.times and run.t0 <= r.times[0] <= run.t_pre)
    return 100.0 * (emitted - firsts) / (steps * b['max_slots'])
