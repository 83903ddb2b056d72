"""int4_prefill_roofline.<cell>: #7's prefill tile (``int4_prefill_kernel``)
against its roofline over the traced window: each prefill whose first
token reached its client inside the window counts the layer products at
its valid prompt tokens (not the packed stream's rows), over the
kernel's device time."""

from portbench import roofline as rf
from portbench.drivers.engine import prompt_tokens
from portbench.trace import kernel_seconds

KERNEL = 'int4_prefill_kernel'


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    a, b = ctx.t_open, ctx.t_close
    llm = ctx.spec['model']['llm']
    nbytes = flops = 0.0
    for r in ctx.run.records:
        if r.times and a <= r.times[0] <= b:
            nb, op = rf.prefill_int4_work(llm, prompt_tokens(r))
            nbytes += nb
            flops += op
    if nbytes == 0:
        return None
    return 100.0 * rf.bound(nbytes, flops)[0] / t
