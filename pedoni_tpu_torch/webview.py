"""Browser-based live viewer — the windowed-GUI equivalent.

The reference ships an interactive miniquad/OpenGL window with mouse-drag
pan, scroll zoom and Space pause (pedoni/src/renderer/mod.rs:54-63,
121-136, 138-168), drawing obstacles as gray rects, waypoints as orange
rects and pedestrians as circles colored by destination through a 6-color
cycle (renderer/mod.rs:9-16).  On a headless TPU host the idiomatic
equivalent is a tiny HTTP server + HTML canvas: point any browser at the
printed URL and get the same camera and the same drawing conventions,
with the render path fully decoupled from the device step loop (the
reference's sim-thread/render-thread split, main.rs:20-26, 94-96 — here a
``SnapshotStream`` keeps the latest device snapshot warm and HTTP threads
only ever read that cache).

Wire format of ``/state`` (binary, little-endian): three u32 (step, n,
total) followed by ``x f32[n]``, ``y f32[n]``, ``dest u8[n]``.  Above
``max_agents`` the snapshot is strided down — a browser canvas does not
need all 1M points to show crowd structure.
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

from .scenario import Scenario

# Destination color cycle, RGB analog of renderer/mod.rs:9-16.
DEST_COLORS = ["#e74c3c", "#e67e22", "#f1c40f", "#2ecc71", "#1abc9c", "#9b59b6"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>pedoni-tpu</title>
<style>
 body { margin:0; background:#181818; color:#ddd; font:13px monospace; overflow:hidden }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px;
        border-radius:4px; pointer-events:none; white-space:pre }
 canvas { display:block; cursor:grab }
</style></head><body>
<div id="hud">connecting…</div><canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let scene = null, frame = null, paused = false;
let cam = { x:0, y:0, scale:1 };          // world -> screen: s = (w - [x,y]) * scale
const COLORS = %COLORS%;

function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);

function fit(){
  if(!scene) return;
  const s = Math.min(cv.width / scene.size[0], cv.height / scene.size[1]) * 0.95;
  cam.scale = s;
  cam.x = scene.size[0]/2 - cv.width/(2*s);
  cam.y = scene.size[1]/2 - cv.height/(2*s);
}

function quad(p0, p1, w){                  // widened segment -> 4 corners
  let dx = p1[0]-p0[0], dy = p1[1]-p0[1];
  const l = Math.hypot(dx, dy) || 1; dx/=l; dy/=l;
  const nx = -dy*w/2, ny = dx*w/2;
  return [[p0[0]+nx,p0[1]+ny],[p1[0]+nx,p1[1]+ny],[p1[0]-nx,p1[1]-ny],[p0[0]-nx,p0[1]-ny]];
}

function draw(){
  ctx.fillStyle = '#181818'; ctx.fillRect(0,0,cv.width,cv.height);
  if(!scene) return;
  const S = cam.scale, X = cam.x, Y = cam.y;
  const px = (x,y)=>[(x-X)*S, (y-Y)*S];
  ctx.fillStyle = '#2a2a2e';                               // field extent
  let [fx,fy] = px(0,0);
  ctx.fillRect(fx, fy, scene.size[0]*S, scene.size[1]*S);
  for(const [kind, col] of [['waypoints','#b8860baa'], ['obstacles','#808080']]){
    ctx.fillStyle = col;
    for(const seg of scene[kind]){
      const q = quad(seg.p0, seg.p1, seg.width);
      ctx.beginPath();
      q.forEach((p,i)=>{ const [sx,sy]=px(p[0],p[1]); i?ctx.lineTo(sx,sy):ctx.moveTo(sx,sy); });
      ctx.closePath(); ctx.fill();
    }
  }
  if(frame){
    const { n, step, xs, ys, dest } = frame;
    const r = Math.max(0.18*S, 1.2);                       // 0.36 m body
    const byColor = COLORS.map(()=>[]);
    for(let i=0;i<n;i++) byColor[dest[i]%%COLORS.length].push(i);
    for(let c=0;c<COLORS.length;c++){
      if(!byColor[c].length) continue;
      ctx.fillStyle = COLORS[c];
      if(r <= 1.6){                                        // far out: fast rects
        for(const i of byColor[c]){
          const [sx,sy]=px(xs[i],ys[i]); ctx.fillRect(sx,sy,r+0.5,r+0.5); }
      } else {                                             // zoomed in: circles
        ctx.beginPath();
        for(const i of byColor[c]){
          const [sx,sy]=px(xs[i],ys[i]);
          ctx.moveTo(sx+r,sy); ctx.arc(sx,sy,r,0,6.2832); }
        ctx.fill();
      }
    }
    hud.textContent = `step ${step}   agents ${frame.total}` +
      (frame.total>n ? ` (showing ${n})` : '') +
      (paused ? '   ⏸ PAUSED (Space)' : '') +
      `\\ndrag: pan   wheel: zoom   Space: pause   0: reset view`;
  }
}

cv.addEventListener('wheel', e => {
  e.preventDefault();
  const f = Math.exp(-e.deltaY * 0.0015);
  const wx = cam.x + e.clientX / cam.scale, wy = cam.y + e.clientY / cam.scale;
  cam.scale *= f;
  cam.x = wx - e.clientX / cam.scale;      // zoom about the cursor
  cam.y = wy - e.clientY / cam.scale;
  draw();
}, { passive:false });
let drag = null;
cv.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; cv.style.cursor='grabbing'; });
addEventListener('mouseup', () => { drag = null; cv.style.cursor='grab'; });
addEventListener('mousemove', e => {
  if(!drag) return;
  cam.x -= (e.clientX - drag[0]) / cam.scale;
  cam.y -= (e.clientY - drag[1]) / cam.scale;
  drag = [e.clientX, e.clientY]; draw();
});
addEventListener('keydown', e => {
  if(e.key === ' '){ e.preventDefault();
    fetch('/control', { method:'POST', body:JSON.stringify({toggle:true}) })
      .then(r=>r.json()).then(j=>{ paused = j.paused; draw(); });
  } else if(e.key === '0'){ fit(); draw(); }
});

async function boot(){
  scene = await (await fetch('/scene')).json();
  resize(); fit(); draw();
  poll();
}
async function poll(){
  try{
    const buf = await (await fetch('/state')).arrayBuffer();
    const dv = new DataView(buf);
    const step = dv.getUint32(0, true), n = dv.getUint32(4, true),
          total = dv.getUint32(8, true);
    frame = { step, n, total,
      xs: new Float32Array(buf, 12, n),
      ys: new Float32Array(buf, 12 + 4*n, n),
      dest: new Uint8Array(buf, 12 + 8*n, n) };
    draw();
  } catch(e){ hud.textContent = 'disconnected: ' + e; }
  setTimeout(poll, 50);
}
boot();
</script></body></html>
"""


class WebViewer:
    """Serve the live view; camera and pause live in the browser.

    ``fetch`` returns (pos [n,2] f32, dest [n] int) for active agents —
    it is called from a background ``SnapshotStream`` (renderer.py),
    never from HTTP handler threads, so a slow device fetch can never
    pile up requests against the runtime, and the stream's adaptive
    pacing keeps an expensive fetch (1M-agent grid unbin over a tunnel)
    from starving the sim loop's host core.  ``paused`` is polled by the
    sim loop (the browser's Space key is the reference's pause toggle,
    renderer/mod.rs:121-136).

    Binds 127.0.0.1 by default; pass ``host="0.0.0.0"`` explicitly to
    expose the (unauthenticated) viewer beyond the local machine.
    """

    def __init__(self, scenario: Scenario,
                 fetch: Callable[[], tuple[np.ndarray, np.ndarray]],
                 port: int = 8000, max_agents: int = 250_000,
                 interval: float = 0.05, host: str = "127.0.0.1") -> None:
        from .renderer import SnapshotStream

        self.scenario = scenario
        self.paused = False
        self._host = host
        self._max_agents = max_agents
        self._latest = self._pack(np.zeros((0, 2), np.float32),
                                  np.zeros((0,), np.int32), 0)
        self._step = 0
        self._stream = SnapshotStream(fetch=fetch, on_frame=self._on_frame,
                                      interval=interval)
        self._scene_json = json.dumps({
            "size": list(scenario.size),
            "obstacles": [{"p0": list(s.p0), "p1": list(s.p1),
                           "width": s.width} for s in scenario.obstacles],
            "waypoints": [{"p0": list(s.p0), "p1": list(s.p1),
                           "width": s.width} for s in scenario.waypoints],
            "colors": DEST_COLORS,
        }).encode()
        self._page = _PAGE.replace("%COLORS%", json.dumps(DEST_COLORS)) \
                          .replace("%%", "%").encode()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path in ("/", "/index.html"):
                    self._send(viewer._page, "text/html; charset=utf-8")
                elif self.path == "/scene":
                    self._send(viewer._scene_json, "application/json")
                elif self.path == "/state":
                    self._send(viewer._latest, "application/octet-stream")
                else:
                    self.send_error(404)

            def _same_origin(self) -> bool:
                """CSRF guard: browsers attach an Origin header to every
                cross-origin POST (even 'simple' text/plain ones), so a
                request whose Origin does not match its own Host header
                came from another page — reject it.  Same-origin requests
                either omit Origin or match."""
                origin = self.headers.get("Origin")
                if origin is None:
                    return True
                return origin == f"http://{self.headers.get('Host', '')}"

            def do_POST(self) -> None:
                if not self._same_origin():
                    self.send_error(403, "cross-origin control rejected")
                elif self.path == "/control":
                    ln = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(ln) or b"{}")
                    except ValueError:
                        body = {}
                    if body.get("toggle"):
                        viewer.paused = not viewer.paused
                    elif "paused" in body:
                        viewer.paused = bool(body["paused"])
                    self._send(json.dumps({"paused": viewer.paused}).encode(),
                               "application/json")
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    # -- snapshot plumbing --------------------------------------------------
    def _pack(self, pos: np.ndarray, dest: np.ndarray, step: int) -> bytes:
        total = len(pos)
        if total > self._max_agents:
            stride = -(-total // self._max_agents)
            pos, dest = pos[::stride], dest[::stride]
        n = len(pos)
        return (struct.pack("<III", step, n, total)
                + np.ascontiguousarray(pos[:, 0], np.float32).tobytes()
                + np.ascontiguousarray(pos[:, 1], np.float32).tobytes()
                + (np.asarray(dest).astype(np.int64) % 256)
                  .astype(np.uint8).tobytes())

    def _on_frame(self, pos: np.ndarray, dest: np.ndarray) -> None:
        self._latest = self._pack(np.asarray(pos), np.asarray(dest),
                                  self._step)

    def set_step(self, step: int) -> None:
        """Advance the step counter shown in the HUD (sim loop calls this)."""
        self._step = step

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "WebViewer":
        self._server_thread.start()
        self._stream.start()
        return self

    def stop(self) -> None:
        self._stream.stop()
        self._server.shutdown()
        self._server.server_close()

    @property
    def url(self) -> str:
        host = self._host
        if host == "0.0.0.0":
            import socket

            host = socket.gethostname()
        return f"http://{host}:{self.port}/"
