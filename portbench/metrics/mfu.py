"""mfu.<cell> (serving cells): the model FLOPs of the useful work done in
the traced window over the window's seconds times the H100's bf16 peak.

The work is counted from the configuration's shapes and the valid tokens:
each request whose first token reached its client inside the window
counts its vision front (at its kept regions) and its prefill (at its
valid prompt tokens, not the packed stream); each later token inside the
window counts one token through the trunk at its context and the heads.
"""

from portbench import roofline as rf
from portbench.drivers.engine import prompt_tokens, regions_kept


def read(ctx):
    a, b = ctx.t_open, ctx.t_close
    m = ctx.spec['model']
    llm, extra = m['llm'], m['num_new_token']
    flops = 0.0
    for r in ctx.run.records:
        if not r.times:
            continue
        p = prompt_tokens(r)
        if a <= r.times[0] <= b:
            flops += (rf.vision_flops(m, regions_kept(r))
                      + rf.llm_prefill_flops(llm, p, extra))
        for k, t in enumerate(r.times[1:], 1):
            if a <= t <= b:
                flops += (rf.llm_token_flops(llm, p + k)
                          + rf.llm_head_flops(llm, extra))
    if flops == 0:
        return None
    return 100.0 * flops / (ctx.trace['window_s'] * rf.H100_BF16_FLOPS)
