"""Serving controller: worker registry + heartbeat + dispatch (a copy of
``groma_tpu/serve/controller.py``; it runs no model).

(reference: groma/serve/controller.py:28-298): workers register and send
heartbeats (expired after CONTROLLER_HEART_BEAT_EXPIRATION seconds, pruned
from dispatch); addresses are dispatched by LOTTERY (speed-weighted random)
or SHORTEST_QUEUE.  The reference runs on FastAPI/uvicorn — unavailable
here, so the same HTTP surface is served by the stdlib ThreadingHTTPServer
(no extra dependency, same endpoints and JSON bodies).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from enum import Enum, auto
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from groma_tpu_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION


class DispatchMethod(Enum):
    LOTTERY = auto()
    SHORTEST_QUEUE = auto()

    @classmethod
    def from_str(cls, name: str) -> 'DispatchMethod':
        return {'lottery': cls.LOTTERY,
                'shortest_queue': cls.SHORTEST_QUEUE}[name]


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = 'shortest_queue'):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self.lock = threading.Lock()
        self.rng = np.random.default_rng(0)

    # ------------------------------------------------------------ registry

    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        if status is None:
            status = {'model_names': [], 'speed': 1, 'queue_length': 0}
        with self.lock:
            self.workers[name] = WorkerInfo(
                model_names=status['model_names'],
                speed=status['speed'],
                queue_length=status['queue_length'],
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        return True

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                return False
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def remove_worker(self, name: str):
        with self.lock:
            self.workers.pop(name, None)

    def refresh_all_workers(self):
        with self.lock:
            self.workers.clear()

    def remove_stale_workers(self):
        """(reference: controller.py:183-191 expiry pruning)."""
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            stale = [n for n, w in self.workers.items()
                     if w.check_heart_beat and w.last_heart_beat < expire]
            for n in stale:
                del self.workers[n]

    def list_models(self) -> List[str]:
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
            return sorted(names)

    # ------------------------------------------------------------ dispatch

    def get_worker_address(self, model_name: str) -> str:
        self.remove_stale_workers()
        with self.lock:
            cands = [(n, w) for n, w in self.workers.items()
                     if model_name in w.model_names]
            if not cands:
                return ''
            if self.dispatch_method is DispatchMethod.LOTTERY:
                speeds = np.array([w.speed for _, w in cands], np.float64)
                total = speeds.sum()
                if total <= 0:
                    return ''
                idx = int(self.rng.choice(len(cands), p=speeds / total))
                return cands[idx][0]
            # shortest queue, normalized by speed
            loads = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            chosen = cands[int(np.argmin(loads))]
            chosen[1].queue_length += 1
            return chosen[0]


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            data = json.loads(self.rfile.read(n) or b'{}')
            if self.path == '/register_worker':
                ok = controller.register_worker(
                    data['worker_name'], data.get('check_heart_beat', True),
                    data.get('worker_status'))
                self._json(200 if ok else 400, {})
            elif self.path == '/receive_heart_beat':
                exist = controller.receive_heart_beat(
                    data['worker_name'], data.get('queue_length', 0))
                self._json(200, {'exist': exist})
            elif self.path == '/get_worker_address':
                self._json(200, {'address': controller.get_worker_address(
                    data['model'])})
            elif self.path == '/remove_worker':
                controller.remove_worker(data['worker_name'])
                self._json(200, {})
            elif self.path == '/refresh_all_workers':
                controller.refresh_all_workers()
                self._json(200, {})
            elif self.path == '/list_models':
                self._json(200, {'models': controller.list_models()})
            else:
                self._json(404, {'error': 'unknown endpoint'})

    return Handler


def serve(host: str = '0.0.0.0', port: int = 21001,
          dispatch_method: str = 'shortest_queue'):
    controller = Controller(dispatch_method)
    httpd = ThreadingHTTPServer((host, port), make_handler(controller))
    httpd.serve_forever()


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=21001)
    ap.add_argument('--dispatch-method', default='shortest_queue',
                    choices=['lottery', 'shortest_queue'])
    a = ap.parse_args()
    serve(a.host, a.port, a.dispatch_method)
