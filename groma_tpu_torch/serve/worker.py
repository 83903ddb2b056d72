"""Model worker on the port: streaming generation over HTTP + controller
heartbeat (counterpart of ``groma_tpu/serve/worker.py``, non-engine
``QuantGenerator`` path).

The HTTP handler, the status report and the controller heartbeat are the
JAX package's (they hold no JAX); this class replaces model loading and
generation.  A request that fails, for instance one asking for more new
tokens than the KV cache has free slots, gets a final frame with
``error_code`` 1 and the error's type and message; the traceback goes to
the log.  The worker keeps serving other requests.
"""

from __future__ import annotations

import argparse
import logging
import threading
from http.server import ThreadingHTTPServer

import numpy as np

from groma_tpu.serve import worker as jax_worker

logger = logging.getLogger('groma_tpu_torch.serve.worker')

# the cache holds max_seq_len + 64 slots, so 64 new tokens always fit
DEFAULT_MAX_NEW_TOKENS = 64


class ModelWorker(jax_worker.ModelWorker):
    def __init__(self, model_dir: str, tokenizer_path=None,
                 worker_name: str = 'groma-worker',
                 model_name: str = 'groma', limit: int = 2,
                 controller_addr: str = '', quant_type: str = 'int8',
                 kv_bits: int = 8, device=None, seed: int = 0):
        """``model_dir``: a checkpoint directory, 'tiny' or 'random'
        (random weights from ``seed`` at the tiny or the full config)."""
        from groma_tpu.data.datasets.base import VLDataSpec
        from groma_tpu.data.tokenizer import StubTokenizer, load_tokenizer
        from groma_tpu_torch.checkpoint.loader import load_quantized
        from groma_tpu_torch.eval.generate_quant import QuantGenerator

        if quant_type != 'int8':
            raise ValueError('only the int8 LLM (--quant_type int8) is '
                             'ported')
        model, qp, self.cfg = load_quantized(model_dir, device=device,
                                             seed=seed)
        if model_dir in ('tiny', 'random'):
            self.tokenizer = StubTokenizer(self.cfg.llm.vocab_size,
                                           self.cfg.max_seq_len)
        else:
            self.tokenizer = load_tokenizer(tokenizer_path or model_dir,
                                            self.cfg.max_seq_len)
        self.spec = VLDataSpec(
            num_image_tokens=self.cfg.num_image_tokens,
            max_region_num=self.cfg.max_region_num,
            max_seq_len=self.cfg.max_seq_len,
            image_size=self.cfg.perceiver.image_size)
        self.generator = QuantGenerator(
            model, qp, max_len=self.cfg.max_seq_len + 64, kv_bits=kv_bits)
        self.engine = None
        self.worker_name = worker_name
        self.model_name = model_name
        self.semaphore = threading.Semaphore(limit)
        self._count_lock = threading.Lock()
        self.queue_length = 0
        self.controller_addr = controller_addr
        if controller_addr:
            self._register()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    def _queued(self, delta: int):
        with self._count_lock:
            self.queue_length += delta

    def generate_stream(self, request: dict):
        """Yield {'text': partial, 'error_code': 0} frames, then a final
        frame that adds the answer's boxes.  Decoding is greedy."""
        from groma_tpu.data.conversation import conv_templates
        from groma_tpu.data.datasets.base import intro_conversation
        from groma_tpu.data.tokenization import expand_template
        from groma_tpu_torch.eval.generate_quant import parse_region_tokens

        with self.semaphore:
            self._queued(1)
            try:
                image = np.asarray(request['image'], np.float32)
                conv = conv_templates.get(request.get('conv_temp', 'llava'))
                messages = intro_conversation(conv)
                for turn in request.get('history', []):
                    messages.append((conv.roles[0], turn[0]))
                    messages.append((conv.roles[1], turn[1]))
                messages.append((conv.roles[0], request['prompt']))
                messages.append((conv.roles[1], None))
                ids = self.tokenizer.encode(conv.get_prompt(messages))
                t = expand_template(ids, None, self.tokenizer.sp,
                                    self.spec.num_image_tokens,
                                    self.spec.max_region_num,
                                    self.spec.max_seq_len)
                max_new = int(request.get('max_new_tokens',
                                          DEFAULT_MAX_NEW_TOKENS))
                chunk = int(request.get('stream_chunk', 16))
                stop_str = request.get('stop') or None
                eos = self.tokenizer.sp.eos

                def cut_stop(text):
                    if stop_str and stop_str in text:
                        return text[:text.index(stop_str)], True
                    return text, False

                tokens, vis = self.generator.generate(
                    image[None], t['input_ids'][None],
                    t['region_slot'][None], t['valid'][None],
                    max_new_tokens=max_new, eos_id=eos)
                row = [int(x) for x in tokens[0]]
                collected = []
                for i in range(0, len(row), chunk):
                    collected = [x for x in row[:i + chunk] if x != eos]
                    text, hit = cut_stop(self.tokenizer.decode(collected))
                    yield {'text': text, 'error_code': 0}
                    if hit:
                        break
                ks = parse_region_tokens(
                    tokens, self.tokenizer.sp.box_idx_start)[0]
                cap = vis['selected_mask'].shape[1]
                boxes = [vis['selected_boxes'][0, k].tolist() for k in ks
                         if k < cap and vis['selected_mask'][0, k]]
                yield {'text': cut_stop(self.tokenizer.decode(collected))[0],
                       'boxes': boxes, 'error_code': 0}
            except Exception as e:   # a request boundary: report, go on
                logger.exception('request failed')
                yield {'text': f'server error: {type(e).__name__}: {e}',
                       'error_code': 1}
            finally:
                self._queued(-1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', default=None)
    ap.add_argument('--tiny', action='store_true',
                    help='random-weight tiny model (serving smoke test)')
    ap.add_argument('--quant_type', default='int8', choices=['int8'])
    ap.add_argument('--kv-bits', type=int, default=8, choices=[16, 8])
    ap.add_argument('--device', default=None)
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
                         device=a.device)
    httpd = ThreadingHTTPServer((a.host, a.port),
                                jax_worker.make_handler(worker))
    httpd.serve_forever()


if __name__ == '__main__':
    main()
