"""engine.admit_ms.<cell>: the mean time from a request's admission (its
session's ``t_admit``, when the engine took it off the queue) to its
first token (``t_first``), over the requests admitted from the window's
opening to the trace's."""


def read(ctx):
    run = ctx.run
    spans = [(s.t_first - s.t_admit) * 1e3
             for s in (r.session for r in run.records)
             if getattr(s, 't_admit', None) is not None
             and s.t_first is not None and run.t0 <= s.t_admit <= run.t_pre]
    return sum(spans) / len(spans) if spans else None
