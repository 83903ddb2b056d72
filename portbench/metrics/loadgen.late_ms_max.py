"""loadgen.late_ms_max.<cell>: how late the open-loop load generator ran:
the largest lag of a submission (``submit`` returned) behind its due
time, over the requests due from the window's opening to the trace's."""


def read(ctx):
    run = ctx.run
    lags = [(r.sent - r.due) * 1e3 for r in run.records
            if r.sent is not None and run.t0 <= r.due <= run.t_pre]
    return max(lags) if lags else None
