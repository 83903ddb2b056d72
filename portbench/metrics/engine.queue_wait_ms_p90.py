"""engine.queue_wait_ms_p90.<cell>: the p90 (linear between order
statistics) of each request's wait in the engine's queue (its session's
``t_admit`` - ``t_submit``, both on the host's ``perf_counter``), over the
requests due from the window's opening to the trace's; a request that
never left the queue is +inf."""

import math


def read(ctx):
    run = ctx.run
    waits = []
    for r in run.records:
        if not run.t0 <= r.due <= run.t_pre:
            continue
        sess = r.session
        if sess is not None and not hasattr(sess, 't_admit'):
            return None               # a program without the spans
        if sess is None or sess.t_admit is None:
            waits.append(math.inf)
        else:
            waits.append((sess.t_admit - sess.t_submit) * 1e3)
    if not waits:
        return None
    waits.sort()
    k = 0.9 * (len(waits) - 1)
    lo = int(k)
    low = waits[lo]
    if k == lo or math.isinf(low):
        return low
    return low + (k - lo) * (waits[lo + 1] - low)
