"""Web chat UI, a copy of ``groma_tpu/serve/web.py`` that resizes and
normalizes with the port's ``data/image_pipeline`` and decodes a PNG
without PIL where PIL is missing (the GPU machine has none).

(reference: groma/serve/gradio_web_server.py — gradio is
unavailable here, so a dependency-free stdlib server ships an HTML/JS chat
page with image upload that routes through the controller to a worker,
mirroring the reference's gradio_web_server -> controller -> worker flow
(reference call stack SURVEY §3.5).

Like the reference UI, grounded answers are rendered visually: the
worker's final frame carries the ``<rK>``-referenced boxes (normalized
cxcywh), which the page draws color-coded on a canvas over the uploaded
image (reference: gradio_web_server returns images with boxes drawn
server-side; drawing client-side keeps the worker payload JSON-only).
Multi-turn state is kept client-side and replayed through the request's
``history`` field.  The reference UI's remaining controls are mirrored
too: regenerate (re-runs the last prompt), up/down votes (appended as
JSON lines to ``--vote-log``, the analogue of gradio_web_server's
vote_last_response logging), and temperature / max-token inputs passed
through to the worker."""

from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import time
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>Groma-TPU</title><style>
body{font-family:sans-serif;max-width:820px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:10em;white-space:pre-wrap}
textarea{width:100%}
canvas{border:1px solid #888;max-width:100%}
.r{font-weight:bold}
</style></head><body>
<h2>Groma-TPU grounded chat</h2>
<input type="file" id="img" accept="image/*" onchange="loadImg()">
<button onclick="reset()">New chat</button><br><br>
<canvas id="cv" width="448" height="448" style="display:none"></canvas><br>
<textarea id="q" rows="2" placeholder="Ask about the image..."></textarea>
<button id="sendbtn" onclick="send()">Send</button>
<button id="regen" onclick="regenerate()" disabled>Regenerate</button>
<button id="up" onclick="vote(1)" disabled>&#128077;</button>
<button id="down" onclick="vote(-1)" disabled>&#128078;</button>
<label>temp <input id="temp" type="number" value="0" min="0" max="2"
 step="0.1" style="width:4em"></label>
<label>max tokens <input id="maxtok" type="number" value="256" min="1"
 max="1024" style="width:5em"></label>
<div id="log"></div>
<script>
const COLORS=['#e6194b','#3cb44b','#4363d8','#f58231','#911eb4',
              '#46f0f0','#f032e6','#bcf60c','#fabebe','#008080'];
let history=[];   // [[user, assistant], ...] replayed to the worker
let imgEl=null;
function reset(){history=[];document.getElementById('log').textContent='';
  if(imgEl)drawBase();}
function loadImg(){
  const f=document.getElementById('img').files[0]; if(!f)return;
  history=[];
  imgEl=new Image();
  imgEl.onload=()=>{drawBase();};
  imgEl.src=URL.createObjectURL(f);
}
function drawBase(){
  const cv=document.getElementById('cv');cv.style.display='block';
  cv.getContext('2d').drawImage(imgEl,0,0,cv.width,cv.height);
}
function drawBoxes(boxes){
  // boxes are normalized cxcywh (the model's pred_boxes convention)
  drawBase();
  const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
  boxes.forEach((b,i)=>{
    const [cx,cy,w,h]=b;
    const x=(cx-w/2)*cv.width, y=(cy-h/2)*cv.height;
    ctx.strokeStyle=COLORS[i%COLORS.length];ctx.lineWidth=3;
    ctx.strokeRect(x,y,w*cv.width,h*cv.height);
    ctx.fillStyle=COLORS[i%COLORS.length];
    ctx.font='16px sans-serif';
    ctx.fillText(String(i),x+3,y+16);
  });
}
function colorize(text,n){
  // color the k-th region-token mention to match the k-th drawn box
  let k=0;
  return text.replace(/&/g,'&amp;').replace(/</g,'&lt;')
    .replace(/&lt;r(\\d+)&gt;/g,(m)=>{
      const c=COLORS[(k<n?k:0)%COLORS.length];
      return '<span class="r" style="color:'+c+'">['+(k++)+']</span>';});
}
let lastQ=null,lastA=null;
async function ask(q){
  const f=document.getElementById('img').files[0];
  if(!f){alert('pick an image');return;}
  const b64=await new Promise(r=>{const fr=new FileReader();
    fr.onload=()=>r(fr.result.split(',')[1]);fr.readAsDataURL(f);});
  const log=document.getElementById('log');
  log.innerHTML+='USER: '+colorize(q,0)+'\\n';
  document.getElementById('sendbtn').disabled=true;
  try{
    const resp=await fetch('/chat',{method:'POST',
      headers:{'Content-Type':'application/json'},
      body:JSON.stringify({image_b64:b64,prompt:q,history:history,
        temperature:parseFloat(document.getElementById('temp').value)||0,
        max_new_tokens:
          parseInt(document.getElementById('maxtok').value)||256})});
    const data=await resp.json();
    const boxes=data.boxes||[];
    log.innerHTML+='ASSISTANT: '+colorize(data.text,boxes.length)+'\\n';
    if(boxes.length)drawBoxes(boxes);
    history.push([q,data.text]);
    lastQ=q;lastA=data.text;
    for(const id of ['regen','up','down'])
      document.getElementById(id).disabled=false;
  }finally{document.getElementById('sendbtn').disabled=false;}
}
async function send(){
  const q=document.getElementById('q').value;
  await ask(q);
  document.getElementById('q').value='';
}
async function regenerate(){
  if(lastQ===null)return;
  history.pop();               // drop the exchange being regenerated
  await ask(lastQ);
}
async function vote(v){
  if(lastA===null)return;
  await fetch('/vote',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({prompt:lastQ,answer:lastA,vote:v})});
  document.getElementById('up').disabled=true;
  document.getElementById('down').disabled=true;
}
</script></body></html>"""


PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # color type -> samples a pixel


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline filters (None, Sub, Up, Average, Paeth) undone."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(
            np.int32)
        if kind == 2:
            line = (line + prev) & 255
        elif kind in (1, 3, 4):
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                line[x] = (line[x] + pred) & 255
        elif kind != 0:
            raise ValueError(f'PNG filter type {kind}')
        out[y] = line
        prev = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced PNG of 8-bit samples (gray, gray + alpha, RGB or
    RGBA) -> RGB uint8 (H, W, 3), with the standard library and numpy."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG (PIL is not installed to read others)')
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + n
    if header is None:
        raise ValueError('a PNG without its IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in PNG_CHANNELS:
        raise ValueError(f'PNG of bit depth {depth}, color type {color}, '
                         f'interlace {interlace} is not read without PIL')
    ch = PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> RGB uint8 (H, W, 3): through PIL, or without
    PIL a PNG through ``decode_png``."""
    try:
        from PIL import Image
    except ImportError:
        return decode_png(data)
    return np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))


def make_handler(controller_addr: str, model_name: str,
                 vote_log: str = 'web_votes.jsonl'):
    def post_json(url, payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header('Content-Type', 'text/html')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, out):
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            data = json.loads(self.rfile.read(n))
            if self.path == '/vote':
                # reference: gradio_web_server vote_last_response appends
                # the rated exchange to a conv log file
                rec = {'ts': time.time(), 'model': model_name,
                       'prompt': data.get('prompt'),
                       'answer': data.get('answer'),
                       'vote': data.get('vote')}
                with open(vote_log, 'a') as f:
                    f.write(json.dumps(rec) + '\n')
                self._reply({'ok': True})
                return
            if self.path != '/chat':
                self.send_response(404)
                self.end_headers()
                return
            # resolve a worker through the controller
            raw = post_json(controller_addr + '/get_worker_address',
                            {'model': model_name})
            addr = json.loads(raw)['address']
            if not addr:
                out = {'text': 'no worker available', 'error_code': 2}
            else:
                from groma_tpu_torch.data.image_pipeline import (normalize,
                                                                 resize)
                img = decode_image(base64.b64decode(data['image_b64']))
                img448, _ = resize(img, (448, 448))
                payload = {'image': normalize(img448).tolist(),
                           'prompt': data['prompt'],
                           'history': data.get('history', []),
                           'temperature': data.get('temperature', 0.0),
                           'max_new_tokens': data.get('max_new_tokens',
                                                      256)}
                raw = post_json(addr + '/worker_generate_stream', payload)
                chunks = [c for c in raw.decode().split('\0') if c.strip()]
                out = json.loads(chunks[-1])
            self._reply(out)

    return Handler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=7860)
    ap.add_argument('--controller-url', default='http://localhost:21001')
    ap.add_argument('--model', default='groma')
    ap.add_argument('--vote-log', default='web_votes.jsonl',
                    help='JSONL file for up/down votes (reference: '
                         'gradio_web_server vote logging)')
    a = ap.parse_args()
    httpd = ThreadingHTTPServer(
        (a.host, a.port),
        make_handler(a.controller_url, a.model, vote_log=a.vote_log))
    print(f'web UI on http://{a.host}:{a.port}')
    httpd.serve_forever()


if __name__ == '__main__':
    main()
