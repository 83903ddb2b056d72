"""int4_decode_roofline.<cell>: #7's decode tile (``int4_decode_kernel``)
against its roofline over the traced window.

The work: every decode step reads each layer's int4 weights and the
head's once, at the rows that were live (the tokens clients got from
decode steps in the window), and each prefill's head row.  The bound is
the larger of its bytes over 3.35 TB/s and its operations over the bf16
peak; the share is that bound over the kernel's device time."""

from portbench import roofline as rf
from portbench.trace import kernel_seconds

KERNEL = 'int4_decode_kernel'


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    before, after = ctx.run.stats_trace
    steps = after['decode_steps'] - before['decode_steps']
    if t <= 0 or steps <= 0:
        return None
    a, b = ctx.t_open, ctx.t_close
    llm = ctx.spec['model']['llm']
    rows = sum(1 for r in ctx.run.records for x in r.times[1:] if a <= x <= b)
    prefills = sum(1 for r in ctx.run.records
                   if r.times and a <= r.times[0] <= b)
    weights, _ = rf.decode_step_int4_work(llm, 0)
    row_bytes, row_ops = rf.decode_step_int4_work(llm, 1)
    head_bytes, head_ops = rf.int4_matmul_work([rf.head_shape(llm)], 1)
    nbytes = steps * weights + rows * (row_bytes - weights) \
        + prefills * head_bytes
    flops = rows * row_ops + prefills * head_ops
    least, _ = rf.bound(nbytes, flops)
    return 100.0 * least / t
