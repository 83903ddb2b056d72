"""paged_attention_roofline.<cell>: #8's paged int8 decode attention
(``paged_attention_kernel``) against its roofline over the traced window:
for each token a client got from a decode step inside the window, every
layer's attention over its context (its valid prompt and the tokens
before it), bytes and operations as ``roofline.paged_attention_work``
counts them, over the kernel's device time."""

from portbench import roofline as rf
from portbench.drivers.engine import prompt_tokens
from portbench.trace import kernel_seconds

KERNEL = 'paged_attention_kernel'


def read(ctx):
    t = kernel_seconds(ctx.trace, KERNEL)
    if t <= 0:
        return None
    a, b = ctx.t_open, ctx.t_close
    llm = ctx.spec['model']['llm']
    nbytes = flops = 0.0
    for r in ctx.run.records:
        if not r.times:
            continue
        p = prompt_tokens(r)
        for k, x in enumerate(r.times[1:], 1):
            if a <= x <= b:
                nb, op = rf.paged_attention_work(llm, p + k)
                nbytes += nb
                flops += op
    if nbytes == 0:
        return None
    return 100.0 * rf.bound(nbytes, flops)[0] / t
