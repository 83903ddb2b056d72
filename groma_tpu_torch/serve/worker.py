"""Model worker on the port: streaming generation over HTTP + controller
heartbeat (counterpart of ``groma_tpu/serve/worker.py``).

The HTTP handler, the status report (with ``engine.stats()`` when the
engine serves) and the controller heartbeat are copies of the JAX
package's; model loading and generation are the port's own.  Requests
go to the continuous-batching ``BatchEngine`` (``--engine``; the
production server is ``--engine --quant_type int4 --kv-bits 8
--paged-kv``), or one at a time to a generator: by default, as in JAX,
``--quant_type none``, the unquantized LLM in ``cfg.llm.dtype`` through
``Generator`` (a bf16 KV cache; a request's ``temperature`` samples), or
with ``int8`` / ``int4`` / ``bf16`` the quantized tree through the greedy
``QuantGenerator``.  A request that
fails, for instance one asking the generator for more new tokens than its
KV cache has free slots, gets a final frame with ``error_code`` 1 and the
error's type and message; the traceback goes to the log.  The worker keeps
serving other requests.

    python -m groma_tpu_torch.serve.worker --tiny --device cpu  # tiny, CPU
    python -m groma_tpu_torch.serve.worker --tiny --device cpu --engine \
        --quant_type int4 --kv-bits 8 --paged-kv      # tiny, on the CPU
    python -m groma_tpu_torch.serve.worker --model-dir <dir> --engine \
        --quant_type int4 --kv-bits 8 --paged-kv      # the card
    python -m groma_tpu_torch.serve.worker --model-dir <dir> --engine \
        --quant_type int8 --kv-bits 8 --prefill-chunk 192  # chunked prefill

The worker runs on the card (``--device cuda``, the default); without a
CUDA device it refuses to start unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from groma_tpu_torch.checkpoint.loader import QUANT_BITS, QUANT_TYPES
from groma_tpu_torch.constants import WORKER_HEART_BEAT_INTERVAL

logger = logging.getLogger('groma_tpu_torch.serve.worker')

# the generator's cache holds max_seq_len + 64 slots, so 64 new tokens
# always fit; the engine's holds ENGINE_MAX_NEW_TOKENS + 8 more
DEFAULT_MAX_NEW_TOKENS = 64
ENGINE_MAX_NEW_TOKENS = 256


def expand_request(tokenizer, spec, request: dict) -> dict:
    """A request's prompt (and ``history``) in its conversation template,
    tokenized and expanded to the model's fixed stream layout
    (``expand_template``): input_ids, labels, region_slot, valid."""
    from groma_tpu_torch.data.conversation import conv_templates
    from groma_tpu_torch.data.datasets.base import intro_conversation
    from groma_tpu_torch.data.tokenization import expand_template

    conv = conv_templates.get(request.get('conv_temp', 'llava'))
    messages = intro_conversation(conv)
    for turn in request.get('history', []):
        messages.append((conv.roles[0], turn[0]))
        messages.append((conv.roles[1], turn[1]))
    messages.append((conv.roles[0], request['prompt']))
    messages.append((conv.roles[1], None))
    ids = tokenizer.encode(conv.get_prompt(messages))
    return expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                           spec.max_region_num, spec.max_seq_len)


class ModelWorker:
    def __init__(self, model_dir: str, tokenizer_path=None,
                 worker_name: str = 'groma-worker',
                 model_name: str = 'groma', limit: int = 2,
                 controller_addr: str = '', quant_type: str = 'none',
                 kv_bits: int = 16, device=None, seed: int = 0,
                 use_engine: bool = False, engine_slots: int = 8,
                 paged_kv: bool = False, kv_pool_tokens: int = 0,
                 prefill_chunk: int = 0, spec_lookahead: int = 0):
        """``model_dir``: a checkpoint directory, 'tiny' or 'random'
        (random weights from ``seed`` at the tiny or the full config).
        ``quant_type``: 'none' (the unquantized LLM; the KV cache is then
        bf16 whatever ``kv_bits``, as in JAX), 'int8', 'int4' or 'bf16'
        (the unquantized fused tree).  ``device``: None is the card
        (``cuda``); 'cpu' runs on the CPU.  ``prefill_chunk`` (0: one-shot)
        and ``spec_lookahead`` go to the engine as its
        ``prefill_chunk_tokens`` and ``spec_lookahead``."""
        from groma_tpu_torch.data.datasets.base import VLDataSpec
        from groma_tpu_torch.data.tokenizer import (StableStubTokenizer,
                                                    load_tokenizer)
        from groma_tpu_torch.checkpoint.loader import (load_quantized,
                                                       load_unquantized)
        from groma_tpu_torch.eval.generate import Generator
        from groma_tpu_torch.eval.generate_quant import QuantGenerator

        if quant_type not in QUANT_TYPES:
            raise ValueError(f'quant_type must be one of {QUANT_TYPES}')
        self.quant_type = quant_type
        if quant_type == 'none':
            model, self.cfg = load_unquantized(model_dir, device=device,
                                               seed=seed)
            qp, kv_bits = None, 16
        else:
            model, qp, self.cfg = load_quantized(model_dir, device=device,
                                                 seed=seed,
                                                 bits=QUANT_BITS[quant_type])
        if model_dir in ('tiny', 'random'):
            # JAX's worker takes the salted StubTokenizer: a stable hash
            # gives a prompt the same ids in every process
            self.tokenizer = StableStubTokenizer(self.cfg.llm.vocab_size,
                                                 self.cfg.max_seq_len)
        else:
            self.tokenizer = load_tokenizer(tokenizer_path or model_dir,
                                            self.cfg.max_seq_len)
        self.spec = VLDataSpec(
            num_image_tokens=self.cfg.num_image_tokens,
            max_region_num=self.cfg.max_region_num,
            max_seq_len=self.cfg.max_seq_len,
            image_size=self.cfg.perceiver.image_size)
        self.engine = self.generator = None
        if use_engine:
            from groma_tpu_torch.serve.engine import BatchEngine
            self.engine = BatchEngine(
                model, qp, max_slots=engine_slots,
                max_len=self.cfg.max_seq_len + ENGINE_MAX_NEW_TOKENS + 8,
                eos_id=self.tokenizer.sp.eos,
                max_new_tokens=ENGINE_MAX_NEW_TOKENS, kv_bits=kv_bits,
                prefill_chunk_tokens=prefill_chunk or None,
                paged_kv=paged_kv, kv_pool_tokens=kv_pool_tokens or None,
                spec_lookahead=spec_lookahead)
            limit = max(limit, engine_slots)
        elif qp is None:
            self.generator = Generator(model,
                                       max_len=self.cfg.max_seq_len + 64)
        else:
            self.generator = QuantGenerator(
                model, qp, max_len=self.cfg.max_seq_len + 64, kv_bits=kv_bits)
        self.worker_name = worker_name
        self.model_name = model_name
        self.semaphore = threading.Semaphore(limit)
        self._count_lock = threading.Lock()
        self.queue_length = 0
        self.controller_addr = controller_addr
        if controller_addr:
            self._register()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    # ------------------------------------------------------- liveness

    def status(self) -> dict:
        out = {'model_names': [self.model_name], 'speed': 1,
               'queue_length': self.queue_length}
        if self.engine is not None:
            # engine observability: TTFT, throughput, occupancy, pages,
            # and the spans' sums (admissions; stall, launch and device
            # seconds), as stats() keeps them
            out['engine'] = self.engine.stats()
        return out

    def _post(self, path: str, payload: dict):
        req = urllib.request.Request(
            self.controller_addr + path,
            data=json.dumps(payload).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read() or b'{}')

    def _register(self):
        self._post('/register_worker', {
            'worker_name': self.worker_name, 'check_heart_beat': True,
            'worker_status': self.status()})

    def _heartbeat_loop(self):
        import time
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                ok = self._post('/receive_heart_beat', {
                    'worker_name': self.worker_name,
                    'queue_length': self.queue_length})
                if not ok.get('exist'):
                    self._register()
            except Exception:
                pass

    def _queued(self, delta: int):
        with self._count_lock:
            self.queue_length += delta

    def generate_stream(self, request: dict):
        """Yield {'text': partial, 'error_code': 0} frames, then a final
        frame that adds the answer's boxes (and ``finish_reason:
        truncated`` when the engine's page pool ran dry).  Decoding is
        greedy, or sampled per request (``temperature``) through the engine
        and the unquantized ``Generator``."""
        from groma_tpu_torch.eval.generate import parse_region_tokens

        with self.semaphore:
            self._queued(1)
            try:
                image = np.asarray(request['image'], np.float32)
                t = expand_request(self.tokenizer, self.spec, request)
                max_new = int(request.get('max_new_tokens',
                                          DEFAULT_MAX_NEW_TOKENS))
                chunk = int(request.get('stream_chunk', 16))
                stop_str = request.get('stop') or None
                eos = self.tokenizer.sp.eos

                def cut_stop(text):
                    if stop_str and stop_str in text:
                        return text[:text.index(stop_str)], True
                    return text, False

                truncated = False
                if self.engine is not None:
                    # tokens stream out as the engine's bursts land;
                    # concurrent requests share the decode steps
                    sess = self.engine.submit(
                        image, t['input_ids'], t['region_slot'], t['valid'],
                        max_new_tokens=max_new,
                        temperature=float(request.get('temperature', 0.0)))
                    collected = []
                    for n, tk in enumerate(sess.token_stream(), 1):
                        if tk != eos:
                            collected.append(tk)
                        if n % chunk == 0:
                            text, hit = cut_stop(
                                self.tokenizer.decode(collected))
                            yield {'text': text, 'error_code': 0}
                            if hit:
                                sess.cancel()   # frees the slot next burst
                                break
                        if n >= max_new:
                            break
                    tokens = np.asarray([sess.tokens], np.int32)
                    vis = {k: v[None] for k, v in sess.vis.items()}
                    truncated = sess.truncated
                else:
                    kw = {}
                    temp = float(request.get('temperature', 0.0))
                    if temp > 0 and self.quant_type == 'none':
                        # the quantized generator is greedy, as in JAX
                        kw['temperature'] = temp
                    tokens, vis = self.generator.generate(
                        image[None], t['input_ids'][None],
                        t['region_slot'][None], t['valid'][None],
                        max_new_tokens=max_new, eos_id=eos, **kw)
                    row = [int(x) for x in tokens[0]]
                    for i in range(0, len(row), chunk):
                        text, hit = cut_stop(self.tokenizer.decode(
                            [x for x in row[:i + chunk] if x != eos]))
                        yield {'text': text, 'error_code': 0}
                        if hit:
                            break
                ks = parse_region_tokens(
                    tokens, self.tokenizer.sp.box_idx_start)[0]
                cap = vis['selected_mask'].shape[1]
                boxes = [vis['selected_boxes'][0, k].tolist() for k in ks
                         if k < cap and vis['selected_mask'][0, k]]
                text = self.tokenizer.decode(
                    [int(x) for x in tokens[0] if x != eos])
                final = {'text': cut_stop(text)[0], 'boxes': boxes,
                         'error_code': 0}
                if truncated:
                    final['finish_reason'] = 'truncated'
                yield final
            except Exception as e:   # a request boundary: report, go on
                logger.exception('request failed')
                yield {'text': f'server error: {type(e).__name__}: {e}',
                       'error_code': 1}
            finally:
                self._queued(-1)


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            data = json.loads(self.rfile.read(n) or b'{}')
            if self.path == '/worker_get_status':
                body = json.dumps(worker.status()).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.end_headers()
                self.wfile.write(body)
            elif self.path == '/worker_generate_stream':
                self.send_response(200)
                self.send_header('Content-Type', 'application/jsonl')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                for chunk in worker.generate_stream(data):
                    payload = (json.dumps(chunk) + '\0').encode()
                    self.wfile.write(f'{len(payload):X}\r\n'.encode())
                    self.wfile.write(payload + b'\r\n')
                self.wfile.write(b'0\r\n\r\n')
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', default=None)
    ap.add_argument('--tiny', action='store_true',
                    help='random-weight tiny model (serving smoke test)')
    ap.add_argument('--engine', action='store_true',
                    help='continuous-batching engine (serve/engine.py)')
    ap.add_argument('--engine-slots', type=int, default=8)
    ap.add_argument('--quant_type', default='none', choices=QUANT_TYPES,
                    help='none: the unquantized LLM (Generator); '
                         'weight-only int8 or int4 LLM, or the bf16 tree')
    ap.add_argument('--kv-bits', type=int, default=16, choices=[16, 8],
                    help='8 = int8 KV cache (quantized paths only)')
    ap.add_argument('--prefill-chunk', type=int, default=0,
                    help='engine chunked prefill: interleave N-token '
                         'prompt chunks with decode bursts (0 = one-shot)')
    ap.add_argument('--spec-lookahead', type=int, default=0,
                    help='engine speculative decoding: G prompt-lookup '
                         'draft tokens per batched verify (greedy-only, '
                         'contiguous KV)')
    ap.add_argument('--paged-kv', action='store_true',
                    help='shared 128-token int8 KV page pool (engine, '
                         '--kv-bits 8)')
    ap.add_argument('--kv-pool-tokens', type=int, default=0,
                    help='page-pool size in tokens (0 = slots x max_len)')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to serve on the "
                         "CPU)")
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=21002)
    ap.add_argument('--controller-address', default='')
    ap.add_argument('--worker-name', default='http://localhost:21002')
    ap.add_argument('--limit-model-concurrency', type=int, default=2)
    a = ap.parse_args()
    model_dir = 'tiny' if a.tiny else a.model_dir
    if not model_dir:
        ap.error('--model-dir or --tiny is required')
    worker = ModelWorker(model_dir, worker_name=a.worker_name,
                         limit=a.limit_model_concurrency,
                         controller_addr=a.controller_address,
                         quant_type=a.quant_type, kv_bits=a.kv_bits,
                         device=a.device, use_engine=a.engine,
                         engine_slots=a.engine_slots, paged_kv=a.paged_kv,
                         kv_pool_tokens=a.kv_pool_tokens,
                         prefill_chunk=a.prefill_chunk,
                         spec_lookahead=a.spec_lookahead)
    httpd = ThreadingHTTPServer((a.host, a.port), make_handler(worker))
    httpd.serve_forever()


if __name__ == '__main__':
    main()
