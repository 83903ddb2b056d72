"""The port's serving front (controller, web UI, moderation hook, gateway
config) against the JAX package's, and one request through the whole
stack: web UI -> the port's controller -> the port's worker (tiny, on the
CPU, the chunked-prefill engine).

The controller and the moderation hook are copies: their sources are the
originals' but for the docstring and the package name.  The controller is
driven over HTTP as ``tests/test_serve.py`` drives JAX's; its lottery
dispatch picks the same workers as JAX's from the same seeded RNG.  The
web UI serves the same page, logs votes, and decodes a PNG without PIL
(``decode_png``) as PIL does, every scanline filter included.
"""

import ast
import base64
import io
import json
import struct
import threading
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import groma_tpu.serve.controller as j_controller
import groma_tpu.serve.moderation as j_moderation
import groma_tpu.serve.web as j_web
import groma_tpu_torch.serve.controller as t_controller
import groma_tpu_torch.serve.moderation as t_moderation
import groma_tpu_torch.serve.web as t_web

ROOT = Path(__file__).resolve().parents[1]


def _post(url, payload, timeout=5):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b'{}')


def _serve(handler):
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f'http://127.0.0.1:{httpd.server_address[1]}'


def _body(module) -> str:
    """A module's source without its docstring, the package named as
    JAX's."""
    tree = ast.parse(Path(module.__file__).read_text())
    del tree.body[0]
    return ast.unparse(tree).replace('groma_tpu_torch.', 'groma_tpu.')


@pytest.mark.parametrize('pair', [(t_controller, j_controller),
                                  (t_moderation, j_moderation)],
                         ids=['controller', 'moderation'])
def test_copies_are_the_originals(pair):
    assert _body(pair[0]) == _body(pair[1])


def test_gateway_config_and_page_are_the_originals():
    for name in ('nginx.conf',):
        got = (ROOT / 'groma_tpu_torch/serve/gateway' / name).read_text()
        assert got == (ROOT / 'groma_tpu/serve/gateway' / name).read_text()
    assert t_web.PAGE == j_web.PAGE


@pytest.fixture
def controller():
    c = t_controller.Controller('shortest_queue')
    httpd, url = _serve(t_controller.make_handler(c))
    yield url, c
    httpd.shutdown()


def test_register_dispatch_heartbeat(controller):
    url, _ = controller
    for name, queue in (('w1', 0), ('w2', 5)):
        _post(url + '/register_worker', {
            'worker_name': name, 'check_heart_beat': True,
            'worker_status': {'model_names': ['groma'], 'speed': 1,
                              'queue_length': queue}})
    assert _post(url + '/list_models', {})['models'] == ['groma']
    assert _post(url + '/get_worker_address',
                 {'model': 'groma'})['address'] == 'w1'
    assert _post(url + '/receive_heart_beat',
                 {'worker_name': 'w1', 'queue_length': 99})['exist']
    assert _post(url + '/get_worker_address',
                 {'model': 'groma'})['address'] == 'w2'
    assert not _post(url + '/receive_heart_beat',
                     {'worker_name': 'ghost', 'queue_length': 0})['exist']
    assert _post(url + '/get_worker_address',
                 {'model': 'nope'})['address'] == ''
    _post(url + '/remove_worker', {'worker_name': 'w2'})
    _post(url + '/refresh_all_workers', {})
    assert _post(url + '/list_models', {})['models'] == []


def test_stale_worker_pruned(controller):
    url, c = controller
    c.register_worker('old', True, {'model_names': ['groma'], 'speed': 1,
                                    'queue_length': 0})
    c.workers['old'].last_heart_beat -= 1000
    assert _post(url + '/get_worker_address',
                 {'model': 'groma'})['address'] == ''
    assert 'old' not in c.workers


def test_lottery_dispatch_picks_as_jax():
    picks = []
    for module in (t_controller, j_controller):
        c = module.Controller('lottery')
        for name, speed in (('a', 1), ('b', 9), ('c', 3)):
            c.register_worker(name, False, {'model_names': ['m'],
                                            'speed': speed,
                                            'queue_length': 0})
        picks.append([c.get_worker_address('m') for _ in range(200)])
    assert picks[0] == picks[1]
    assert picks[0].count('b') > 100


def test_moderation_hook_fails_open():
    try:
        assert not t_moderation.violates_moderation('anything')
        t_moderation.set_moderation_checker(lambda text: 'bad' in text)
        assert t_moderation.violates_moderation('a bad word')
        assert not t_moderation.violates_moderation('fine')

        def broken(text):
            raise RuntimeError('moderation service down')
        t_moderation.set_moderation_checker(broken)
        assert not t_moderation.violates_moderation('a bad word')
    finally:
        t_moderation._checker = None


def _png(img) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='PNG')
    return buf.getvalue()


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA'])
def test_decode_png_without_pil_matches_pil(mode):
    """A smooth gradient and noise, which PIL's encoder writes with
    several of the five filters."""
    from PIL import Image
    rng = np.random.default_rng(0)
    h, w = 37, 53
    ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None] * 5) % 256
    img = np.stack([ramp, ramp[::-1], rng.integers(0, 256, (h, w))],
                   -1).astype(np.uint8)
    img[h // 2:] = rng.integers(0, 256, (h - h // 2, w, 3))
    data = _png(np.asarray(Image.fromarray(img).convert(mode)))
    want = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
    np.testing.assert_array_equal(t_web.decode_png(data), want)
    np.testing.assert_array_equal(t_web.decode_image(data), want)


def _png_each_filter(img) -> bytes:
    """An RGB PNG whose row y is written with filter y % 5 (None, Sub, Up,
    Average, Paeth), by the PNG specification's rules."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int64)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        kind = y % 5
        if kind == 4:
            pa, pb = np.abs(up - upleft), np.abs(left - upleft)
            pc = np.abs(left + up - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        else:
            pred = [0 * cur, left, up, (left + up) // 2][kind]
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    return (t_web.PNG_SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


def test_decode_png_takes_every_filter():
    img = np.random.default_rng(1).integers(0, 256, (11, 7, 3), np.uint8)
    np.testing.assert_array_equal(t_web.decode_png(_png_each_filter(img)),
                                  img)


def test_web_page_and_votes(tmp_path):
    vlog = tmp_path / 'votes.jsonl'
    httpd, url = _serve(t_web.make_handler('http://127.0.0.1:1', 'groma',
                                           vote_log=str(vlog)))
    try:
        with urllib.request.urlopen(url + '/', timeout=30) as r:
            page = r.read().decode()
        for needle in ('canvas', 'regenerate()', 'vote(1)', 'temp',
                       'max tokens'):
            assert needle in page, needle
        assert _post(url + '/vote', {'prompt': 'p', 'answer': 'a',
                                     'vote': -1})['ok'] is True
        rec = json.loads(vlog.read_text().strip())
        assert rec['vote'] == -1 and rec['prompt'] == 'p'
        assert rec['model'] == 'groma'
    finally:
        httpd.shutdown()


def test_web_to_controller_to_worker(controller, monkeypatch):
    """One request through the whole stack on the CPU: the worker (tiny,
    int8, the chunked-prefill engine) registers with the port's
    controller, the web UI resolves it there and streams its answer.  The
    web UI resizes to 448², the full model's input; the tiny model takes
    56², so the test resizes to that."""
    import groma_tpu_torch.data.image_pipeline as image_pipeline
    from groma_tpu_torch.serve import worker as worker_mod
    url, c = controller
    resize = image_pipeline.resize
    monkeypatch.setattr(image_pipeline, 'resize',
                        lambda img, size, boxes=None: resize(img, (56, 56),
                                                             boxes))
    worker = worker_mod.ModelWorker(
        'tiny', device='cpu', quant_type='int8', kv_bits=8,
        use_engine=True, engine_slots=2, prefill_chunk=16,
        worker_name='pending', controller_addr='')
    w_httpd, w_url = _serve(worker_mod.make_handler(worker))
    worker.worker_name, worker.controller_addr = w_url, url
    worker._register()
    web, web_url = _serve(t_web.make_handler(url, 'groma'))
    try:
        assert c.list_models() == ['groma']
        img = np.random.default_rng(0).integers(0, 256, (90, 120, 3),
                                                np.uint8)
        out = _post(web_url + '/chat', {
            'image_b64': base64.b64encode(_png(img)).decode(),
            'prompt': 'Locate the dog.', 'max_new_tokens': 5}, timeout=300)
        assert out['error_code'] == 0 and 'boxes' in out, out
        st = worker.status()
        assert st['engine']['finished'] == 1 and st['queue_length'] == 0
        # dispatch raised the worker's queue by one (shortest queue)
        assert c.workers[w_url].queue_length == 1
    finally:
        web.shutdown()
        w_httpd.shutdown()
        worker.engine.close()
