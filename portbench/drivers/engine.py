"""Serving cells: Groma's continuous-batching engine (``BatchEngine``) in
process, driven through ``submit`` and each session's streamed tokens.

Set-up builds the system as the worker's flags build it (the config
file's ``deployment``): the model with the benchmark's weights, the LLM
quantized by the port's ``quantize_groma_llm``, the engine; then it warms
up the shapes the traffic uses (the b = 1 prefill and the greedy decode
burst) with one request per slot.

The window loop is the workload file's ``arrivals``, run by one client
thread that sends every request and reads every stream:
* ``closed``: ``clients`` requests are kept in flight, the next sent as
  one ends; the window opens once every slot is busy;
* ``poisson``: each request is sent at its due time (``lead_s`` seconds
  of schedule run before the window opens).

Every request records its due and submit times and the time each token
reached the client: the client looks at every open stream (the
session's ``tokens`` and ``done``) each ``POLL_S`` and stamps what is
new, so one thread wakes at a fixed pace, not one thread for each token
the engine streams.  Once the window closes nothing more is submitted and
every request already sent is waited for, a minute at the most.

The engine never stops on EOS here (``eos_id`` -1, the engine's 'never
stop' value): the weights are random, and each answer runs to the cap
the traffic drew for it, so that every seed does the same work.
"""

from __future__ import annotations

import itertools
import math
import sys
import threading
import time

import numpy as np
import torch

from portbench import weights
from portbench.traffic import Traffic

WAIT_AFTER_CLOSE_S = 60.0
POLL_S = 0.002            # how often the client looks at the streams


def groma_config(spec: dict):
    """The config file's sizes -> the port's ``GromaConfig``."""
    from groma_tpu_torch.config import (DDETRConfig, GromaConfig, LlamaConfig,
                                        PerceiverConfig, ViTConfig)
    m = spec['model']
    llm = m['llm']
    lc = LlamaConfig(vocab_size=llm['vocab_size'],
                     hidden_size=llm['hidden_size'],
                     intermediate_size=llm['intermediate_size'],
                     num_layers=llm['num_hidden_layers'],
                     num_heads=llm['num_attention_heads'],
                     num_kv_heads=llm['num_key_value_heads'],
                     max_position_embeddings=llm['max_position_embeddings'],
                     rope_theta=llm['rope_theta'],
                     rms_norm_eps=llm['rms_norm_eps'], dtype=m['llm_dtype'])
    vit = ViTConfig(**m['vit'])
    ddetr = DDETRConfig(**m['ddetr'])
    pc = PerceiverConfig(vit=vit, ddetr=ddetr, image_size=m['image_size'])
    return GromaConfig(
        llm=lc, perceiver=pc, num_new_token=m['num_new_token'],
        nms_thres=m['nms_thres'], box_score_thres=m['box_score_thres'],
        max_region_num=m['max_region_num'],
        num_image_tokens=m['num_image_tokens'],
        max_seq_len=m['max_seq_len'], region_roi_out=m['region_roi_out'],
        region_num_fuse=m['region_num_fuse'],
        region_gn_groups=m['region_gn_groups'])


def param_table(cfg) -> list:
    """(name, shape) of every parameter of the served model, in the Groma
    checkpoint layout."""
    from groma_tpu_torch.models.groma import GromaModel
    model = GromaModel(cfg, device='meta', llm_linear_dtype=torch.bfloat16)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def build_model(cfg, table, seed, device):
    """The model with the benchmark's weights, each cast to the dtype its
    module keeps."""
    from groma_tpu_torch.models.groma import GromaModel
    model = GromaModel(cfg, device='meta', llm_linear_dtype=torch.bfloat16)
    want = model.state_dict()
    for _, drawn in weights.draw(table, seed, device):
        model.load_state_dict({k: v.to(want[k].dtype)
                               for k, v in drawn.items()},
                              strict=False, assign=True)
        del drawn
    left = [k for k, v in model.state_dict().items() if v.is_meta]
    if left:
        raise RuntimeError(f'parameters left without weights: {left[:5]}')
    return model.eval()


class _Phases:
    """Set-up's phases on the host clock, printed to standard error."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def __call__(self, what):
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f'set-up: {what} {now - self.t:.2f} s', file=sys.stderr,
              flush=True)
        self.t = now


class Record:
    """One request as its client saw it."""

    def __init__(self, req, due_abs):
        self.req = req
        self.due = due_abs           # perf_counter: when it was due
        self.sent = None             # perf_counter: when submit returned
        self.times = []              # perf_counter of each token's arrival
        self.tokens = []
        self.error = None
        self.session = None

    @property
    def done(self) -> bool:
        return self.error is not None or len(self.times) >= self.req.max_new

    def send(self, system):
        try:
            self.session = system.submit(self.req)
            self.sent = time.perf_counter()
        except Exception as e:   # a failed request is counted, not fatal
            self.error = f'{type(e).__name__}: {e}'

    def collect(self, now) -> bool:
        """Take the tokens the engine has streamed since the last look,
        each stamped ``now``; True once the stream has ended."""
        sess = self.session
        if sess is None:
            return True
        ended = sess.done            # set after the stream's last token
        got = len(sess.tokens)
        have = len(self.tokens)
        if got > have:
            self.tokens.extend(sess.tokens[have:got])
            self.times.extend([now] * (got - have))
        if ended:
            if sess.error is not None:
                self.error = f'engine died mid-stream: {sess.error!r}'
            elif sess.truncated:
                self.error = 'truncated: the page pool ran dry'
        return ended


class System:
    """The engine and what the check needs of the run."""

    def __init__(self, spec, workload, seed, device):
        from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
        from groma_tpu_torch.serve.engine import BatchEngine
        dep = spec['deployment']
        if dep['quant_type'] != 'int4':
            raise ValueError('this driver serves the int4 tree')
        self.spec, self.workload, self.seed = spec, workload, seed
        self.device = torch.device(device)
        clock = _Phases(self.device)
        self.cfg = groma_config(spec)
        self.table = param_table(self.cfg)
        model = build_model(self.cfg, self.table, seed, self.device)
        clock('weights')
        qp = quantize_groma_llm(model, self.cfg, bits=4)
        # the trunk and the head live on in the quantized tree only
        model.llm.model.layers.to_empty(device='meta')
        model.llm.lm_head.to_empty(device='meta')
        clock('quantize')
        max_new = dep['max_new_tokens']
        self.engine = BatchEngine(
            model, qp, max_slots=dep['engine_slots'],
            max_len=self.cfg.max_seq_len + max_new + 8, eos_id=-1,
            chunk=dep['chunk'], max_new_tokens=max_new,
            kv_bits=dep['kv_bits'], paged_kv=dep['paged_kv'])
        self.traffic = Traffic(workload['traffic'], spec['model'], seed)
        pool = workload['traffic']['pool']
        self.requests = [self.traffic.request(i) for i in range(pool)]
        clock('engine and requests')
        self._warm_up()
        clock('warm-up')

    def _warm_up(self):
        """One request per slot, each for two bursts and one token: the
        prefill graph and the greedy burst are captured."""
        chunk = self.spec['deployment']['chunk']
        sessions = [self.submit(r, 2 * chunk + 1) for r in
                    self.requests[:self.engine.max_slots]]
        for s in sessions:
            for _ in s.token_stream():
                pass
        if self.device.type == 'cuda':
            torch.cuda.synchronize()

    def submit(self, req, max_new=None):
        return self.engine.submit(req.image, req.input_ids, req.region_slot,
                                  req.valid,
                                  max_new_tokens=max_new or req.max_new)

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self):
        self.engine.close()
        self.engine = None


class Run:
    """One window of a serving cell; see the module's docstring.  The
    caller's thread keeps the window's time (and opens and closes the
    trace, which the profiler takes only from the thread that started
    it); one client thread sends every request and reads every stream."""

    def __init__(self, system, seconds, trace=None, trace_seconds=0.0):
        self.system = system
        self.seconds = seconds
        self.trace, self.trace_seconds = trace, trace_seconds
        self.records = []
        self.stats_open = self.stats_close = None
        self.stats_trace = None
        self.t0 = self.t1 = self.t_pre = None
        self.stop = threading.Event()
        self.opened = threading.Event()
        self.failure = None

    def run(self):
        client = threading.Thread(target=self._client, daemon=True)
        client.start()
        self.opened.wait()
        if self.failure is None:
            self._window()
        self.stop.set()
        client.join(WAIT_AFTER_CLOSE_S + 10.0)
        if self.failure is not None:
            raise RuntimeError('the load generator failed') \
                from self.failure
        return self

    def _window(self):
        """The window's clock.  A trace covers its last ``trace_seconds``:
        the profiler holds the interpreter while it starts and, for some
        seconds, while it stops, so every host-side number of a traced
        run is taken over the part before the trace (``t_pre``), and the
        stop falls after the window has closed."""
        if self.trace is not None:
            _sleep_until(self.t1 - self.trace_seconds)
            self.t_pre = time.perf_counter()
            before = self.system.stats()
            self.trace.open()
            _sleep_until(self.trace.t_open + self.trace_seconds)
            self.trace.close()
            self.stats_trace = (before, self.system.stats())
        _sleep_until(self.t1)
        self.stats_close = self.system.stats()

    def _open_window(self):
        self.stats_open = self.system.stats()
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds
        self.opened.set()

    def _client(self):
        try:
            self._load()
        except BaseException as e:   # noqa: BLE001 - the window reports it
            self.failure = e
            self.opened.set()

    def _load(self):
        """Every ``POLL_S``: take the streamed tokens, then send what is
        due: in a closed loop a request for each client whose last one
        ended, in an open loop each request whose due time has come.
        Once the window has closed nothing more is sent, and the streams
        already open are read to their end, a minute at the most."""
        arr = self.system.workload['traffic']['arrivals']
        closed = arr['kind'] == 'closed'
        reqs = self.system.requests
        traffic = self.system.traffic
        slots = self.system.engine.max_slots
        live = []
        start = time.perf_counter()
        lead = arr.get('lead_s', 0.0)
        fill_by = start + WAIT_AFTER_CLOSE_S
        end = None
        for i in itertools.count():
            if closed:
                due = None
            else:
                due = start + traffic.due(i)
                if due > start + lead + self.seconds:
                    due = math.inf
            while True:
                now = time.perf_counter()
                live = [r for r in live if not r.collect(now)]
                if self.stop.is_set():
                    end = end or now + WAIT_AFTER_CLOSE_S
                    if not live or now > end:
                        return
                elif not self.opened.is_set():
                    if closed and self.system.stats()['active_slots'] \
                            >= slots:
                        self._open_window()
                    elif not closed and now >= start + lead:
                        self._open_window()
                    elif closed and now > fill_by:
                        raise RuntimeError('the slots never all filled')
                if not self.stop.is_set() and (
                        len(live) < arr['clients'] if closed else now >= due):
                    break
                wake = now + POLL_S if closed else min(now + POLL_S, due)
                _sleep_until(wake)
            rec = Record(reqs[i % len(reqs)], now if closed else due)
            self.records.append(rec)
            rec.send(self.system)
            live.append(rec)


def _sleep_until(t):
    time.sleep(max(0.0, t - time.perf_counter()))


# ------------------------------------------------------------ the numbers


def prompt_tokens(rec) -> int:
    """The valid tokens of a request's stream once its unkept region
    pairs drop out: what its prefill really computes."""
    r = rec.req
    mask = rec.session.vis['selected_mask']
    slot = r.region_slot
    keep = r.valid & ((slot < 0) | mask[np.clip(slot, 0, None)])
    return int(keep.sum())


def regions_kept(rec) -> int:
    return int(rec.session.vis['selected_mask'].sum())


def percentile(values, q):
    """The q-th percentile, linear between order statistics; a missing
    value (a failed request) is +inf."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(run) -> dict:
    """Every end-to-end number this driver measures, by metric name."""
    t0, t1, s = run.t0, run.t1, run.seconds
    recs = run.records
    tokens = sum(1 for r in recs for t in r.times if t0 <= t <= t1)
    tpot = [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
            for r in recs if r.error is None and len(r.times) >= 2
            and r.done and t0 <= r.times[-1] <= t1]
    open_loop = run.system.workload['traffic']['arrivals']['kind'] != 'closed'
    out = {'output_tok_per_s': tokens / s,
           'tpot_p90_ms': percentile(tpot, 90)}
    if open_loop:
        due = [r for r in recs if t0 <= r.due <= t1]
        ttft = [(r.times[0] - r.due) * 1e3 if r.times and r.error is None
                else float('inf') for r in due]
        out['ttft_p90_ms'] = percentile(ttft, 90)
    return out


def counts(run) -> tuple:
    """(attempted, failed): requests due in the window (open loop) or
    sent in it (closed), and those of them that failed or never ended."""
    if run.system.workload['traffic']['arrivals']['kind'] == 'closed':
        mine = [r for r in run.records
                if r.sent is not None and r.sent <= run.t1
                and (not r.times or r.times[-1] >= run.t0)]
    else:
        mine = [r for r in run.records if run.t0 <= r.due <= run.t1]
    failed = sum(1 for r in mine if r.error is not None or not r.done)
    return len(mine), failed


# ------------------------------------------------- the harness's calls


def setup(spec, workload, seed, device):
    return System(spec, workload, seed, device)


def window(system, seconds, trace=None, trace_seconds=0.0):
    return Run(system, seconds, trace, trace_seconds).run()


def release(system):
    """Free the program's state before the reference runs."""
    system.close()


def check(system, run, seed, device, control=False) -> dict:
    """The readings of ``check_served.compare`` over the sample the
    workload's ``check`` asks for."""
    from portbench import check_served
    c = system.workload['check']
    picked = check_served.sample(run.records, seed, c['min_tokens'],
                                 c['max_requests'])
    return check_served.compare(system.spec, system.table, picked, seed,
                                device, control=control)
