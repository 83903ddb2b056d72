"""engine.vision_device_ms.<cell>: the mean device time of the prefill's
vision part (DINOv2, DDETR, the selection, the region encoder, token
surgery), from the timing events that the captured prefill records (the
session's ``prefill_device_ms['vision']``), over the requests admitted
from the window's opening to the trace's."""


def read(ctx):
    run = ctx.run
    ms = [s.prefill_device_ms['vision']
          for s in (r.session for r in run.records)
          if getattr(s, 'prefill_device_ms', None) is not None
          and s.t_first is not None and run.t0 <= s.t_admit <= run.t_pre]
    return sum(ms) / len(ms) if ms else None
