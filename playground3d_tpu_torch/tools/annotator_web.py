"""Browser front-end for the annotation review shell — the pixel-space GUI.

A numpy copy of ``playground3d_tpu/tools/annotator_web.py`` with its imports pointed
at the port's modules.

The reference's flagship ground-truth tool is a mouse-driven multi-camera
OpenCV window (manual_annotator_state_v3.py:2865 ``run``; keybindings
documented in its README.md:1-16): click to place boxes, drag to move them,
single-key edits, frame/camera stepping. This module serves that same
pixel-space click/drag workflow over HTTP so it works on a display-less
host from any browser:

* a single-page ``<canvas>`` app shows the current frame with the session's
  3D boxes projected through the camera geometry (ids + class labels);
* mouse clicks/drags are converted image -> roadway **server-side** through
  the camera homography (EB/WB dual-correspondence dispatch, reference
  homography.py:840-847), so the browser never needs the geometry;
* every edit is dispatched through the SAME :class:`AnnotatorShell`
  commands — undo, interpolation, outlier removal, spline ops, detector
  auto-label, CSV/npz save all come along for free and stay testable;
* the reference keybindings work in the browser (README.md:1-16 parity:
  8/9 frame step, [/] camera, a add, r delete-onward, c/v copy/class,
  u undo, w save), plus a free-form command box for the full shell surface.

No third-party server stack: ``http.server`` + the repo's own PNG codec.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.tools.annotator_shell import AnnotatorShell
from playground3d_tpu_torch.utils.constants import CLASS_NAMES, EB_WB_Y_SPLIT_FT


class AnnotatorWeb:
    """Stateless-HTTP adapter around one :class:`AnnotatorShell`.

    All mutation flows through ``shell.execute`` (one writer; the HTTP
    server handles requests on a single shell lock, so concurrent browser
    tabs serialize instead of racing).
    """

    def __init__(self, shell: AnnotatorShell, height: int = 1080, width: int = 1920):
        self.shell = shell
        self.h, self.w = int(height), int(width)
        self._lock = threading.Lock()
        self._log: list = []
        shell.out = self  # capture _say output for the browser log

    # shell message sink (file-like)
    def write(self, msg: str) -> None:
        if msg.strip():
            self._log.append(msg.strip())
            del self._log[:-50]

    def flush(self) -> None:  # pragma: no cover - file-api completeness
        pass

    # -- geometry ------------------------------------------------------------
    def _px_to_space(self, x_px: float, y_px: float):
        """One image pixel -> roadway (x, y) ft through the current camera's
        ground-plane homography with EB/WB dispatch."""
        reg = self.shell.registry
        c = reg.index(self.shell.camera)
        pt = np.full((1, 8, 2), (x_px, y_px), np.float64)
        sp = G.im_to_space(pt, reg.H[c, 0], np.zeros(1))
        if sp[0, 0, 1] > EB_WB_Y_SPLIT_FT:
            sp = G.im_to_space(pt, reg.H[c, 1], np.zeros(1))
        return float(sp[0, 0, 0]), float(sp[0, 0, 1])

    def _labels_px(self):
        """Current frame's labels with projected image corners [8,2]."""
        pairs = sorted(self.shell._labels_at(), key=lambda p: p[0])
        out = []
        reg = self.shell.registry
        if not pairs:
            return out
        states = np.stack([l.state7 for _, l in pairs])
        corners = None
        if reg is not None:
            c = reg.index(self.shell.camera)
            corners = G.state_to_im_banked(states, reg.P[c, 0], reg.P[c, 1])
        for i, (oid, l) in enumerate(pairs):
            out.append(
                {
                    "oid": int(oid),
                    "class_id": int(l.class_id),
                    "class": CLASS_NAMES[int(l.class_id)],
                    "state7": [round(float(v), 3) for v in l.state7],
                    "corners_px": None
                    if corners is None
                    else [[round(float(v), 1) for v in p] for p in corners[i]],
                }
            )
        return out

    # -- request handlers ------------------------------------------------------
    def state(self) -> dict:
        sh = self.shell
        return {
            "frame": sh.frame,
            "t": sh.t,
            "camera": sh.camera,
            "cameras": list(sh.cameras),
            "labels": self._labels_px(),
            "log": self._log[-12:],
            "classes": list(CLASS_NAMES),
        }

    def frame_png(self) -> bytes:
        from playground3d_tpu_torch.data.video import encode_png
        from playground3d_tpu_torch.tools.visualize import plot_boxes

        sh = self.shell
        if sh.frames is not None:
            frame = np.asarray(sh.frames(sh.frame, sh.camera), np.float32)
            if frame.dtype == np.float32 and frame.max() > 1.5:
                frame = frame / 255.0
        else:
            frame = np.zeros((self.h, self.w, 3), np.float32)
        labels = self._labels_px()
        boxes = [l["corners_px"] for l in labels if l["corners_px"] is not None]
        if boxes:
            frame = plot_boxes(frame, np.asarray(boxes, np.float64))
        return encode_png(frame)

    def pixel(self, req: dict) -> None:
        """Mouse ops in image pixels -> shell commands in roadway feet."""
        op = req["op"]
        if op == "add":
            x, y = self._px_to_space(req["x"], req["y"])
            self.shell.execute(f"add {x:.3f} {y:.3f} {req.get('cls', 0)}")
        elif op == "shift":
            x0, y0 = self._px_to_space(req["x0"], req["y0"])
            x1, y1 = self._px_to_space(req["x1"], req["y1"])
            self.shell.execute(f"shift {int(req['oid'])} {x1 - x0:.3f} {y1 - y0:.3f}")
        else:
            raise ValueError(f"unknown pixel op {op!r}")

    def cmd(self, line: str) -> None:
        self.shell.execute(line)

    # -- server ----------------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
        web = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                with web._lock:
                    if self.path == "/" or self.path.startswith("/index"):
                        self._send(200, PAGE.encode(), "text/html; charset=utf-8")
                    elif self.path.startswith("/state"):
                        self._send(
                            200, json.dumps(web.state()).encode(), "application/json"
                        )
                    elif self.path.startswith("/frame.png"):
                        self._send(200, web.frame_png(), "image/png")
                    else:
                        self._send(404, b"not found", "text/plain")

            def do_POST(self):
                with web._lock:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n) or b"{}")
                        if self.path.startswith("/cmd"):
                            web.cmd(req["line"])
                        elif self.path.startswith("/pixel"):
                            web.pixel(req)
                        else:
                            self._send(404, b"not found", "text/plain")
                            return
                        self._send(
                            200, json.dumps(web.state()).encode(), "application/json"
                        )
                    except Exception as e:  # keep the session alive on bad input
                        self._send(
                            400, json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8008) -> None:
        srv = self.make_server(host, port)
        print(f"annotator web UI: http://{host}:{srv.server_address[1]}/")
        srv.serve_forever()


# Single-page app. Reference keybinding parity (README.md:1-16) is in the
# keydown handler; mouse click = select / add (in add mode), drag = shift.
PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>3D annotator</title>
<style>
 body{background:#14141e;color:#d8d8e0;font:13px monospace;margin:0;display:flex}
 #side{width:330px;padding:10px;overflow-y:auto;height:100vh;box-sizing:border-box}
 #main{flex:1;display:flex;flex-direction:column;align-items:center;padding:8px}
 canvas{max-width:100%;border:1px solid #333;cursor:crosshair}
 .sel{color:#ffd166}.hd{color:#7fd1b9;margin-top:8px}
 input{width:100%;background:#1e1e2a;color:#d8d8e0;border:1px solid #444;padding:4px;box-sizing:border-box}
 #log{white-space:pre-wrap;color:#9a9ab0}
 table{border-collapse:collapse;width:100%}td{padding:1px 4px}
 tr.selrow{background:#2a2a40}
</style></head><body>
<div id="side">
 <div class="hd">frame <span id="frame"></span> · cam <span id="cam"></span> · t <span id="t"></span></div>
 <div class="hd">keys: 8/9 frame · [/] cam · a add-mode · r delete&rarr; · c copy · p paste · u undo · w save</div>
 <div class="hd">labels (click row or box to select)</div>
 <table id="labels"></table>
 <div class="hd">command</div>
 <input id="cmd" placeholder="e.g. dim 3 0.5 0 0 | interp 3 | auto | save out.csv">
 <div class="hd">log</div><div id="log"></div>
</div>
<div id="main"><canvas id="cv" width="1920" height="1080"></canvas></div>
<script>
let S=null, sel=null, addMode=false, drag=null;
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
const img=new Image();
function refresh(st){ if(st){S=st; draw();} img.src='/frame.png?'+Date.now(); }
img.onload=()=>draw();
async function getState(){ refresh(await (await fetch('/state')).json()); }
async function post(path,body){ const r=await fetch(path,{method:'POST',body:JSON.stringify(body)});
  if(r.ok) refresh(await r.json()); else { const e=await r.json(); S.log.push('error: '+e.error); draw(); } }
function cmd(line){ post('/cmd',{line}); }
function draw(){
  if(!S) return;
  ctx.clearRect(0,0,cv.width,cv.height);
  if(img.complete&&img.naturalWidth){ cv.width=img.naturalWidth; cv.height=img.naturalHeight;
    ctx.drawImage(img,0,0); }
  for(const l of S.labels){ if(!l.corners_px) continue;
    ctx.strokeStyle = l.oid===sel ? '#ffd166' : '#7fd1b9'; ctx.lineWidth = l.oid===sel?2:1;
    const c=l.corners_px, E=[[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],[0,4],[1,5],[2,6],[3,7]];
    ctx.beginPath(); for(const [a,b] of E){ ctx.moveTo(c[a][0],c[a][1]); ctx.lineTo(c[b][0],c[b][1]); } ctx.stroke();
    ctx.fillStyle=ctx.strokeStyle; ctx.fillText(l.oid+':'+l.class, c[0][0], c[0][1]-4); }
  document.getElementById('frame').textContent=S.frame;
  document.getElementById('cam').textContent=S.camera+' ('+S.cameras.join(',')+')';
  document.getElementById('t').textContent=S.t.toFixed(3);
  document.getElementById('log').textContent=S.log.join('\\n');
  const tb=document.getElementById('labels');
  tb.innerHTML=S.labels.map(l=>`<tr class="${l.oid===sel?'selrow':''}" onclick="sel=${l.oid};draw()">`+
    `<td>${l.oid}</td><td>${l.class}</td><td>x ${l.state7[0]} y ${l.state7[1]}</td></tr>`).join('');
}
function hit(x,y){ let best=null,bd=1e18;
  for(const l of S.labels){ if(!l.corners_px) continue;
    const xs=l.corners_px.map(p=>p[0]), ys=l.corners_px.map(p=>p[1]);
    const cx=(Math.min(...xs)+Math.max(...xs))/2, cy=(Math.min(...ys)+Math.max(...ys))/2;
    if(x>=Math.min(...xs)-6&&x<=Math.max(...xs)+6&&y>=Math.min(...ys)-6&&y<=Math.max(...ys)+6){
      const d=(cx-x)**2+(cy-y)**2; if(d<bd){bd=d;best=l.oid;} } }
  return best; }
function pos(ev){ const r=cv.getBoundingClientRect();
  return [ (ev.clientX-r.left)*cv.width/r.width, (ev.clientY-r.top)*cv.height/r.height ]; }
cv.addEventListener('mousedown',ev=>{ const [x,y]=pos(ev);
  if(addMode){ post('/pixel',{op:'add',x,y}); addMode=false; return; }
  const h=hit(x,y); if(h!==null){ sel=h; drag={x0:x,y0:y}; } draw(); });
cv.addEventListener('mouseup',ev=>{ if(drag&&sel!==null){ const [x,y]=pos(ev);
  if((x-drag.x0)**2+(y-drag.y0)**2>9) post('/pixel',{op:'shift',oid:sel,x0:drag.x0,y0:drag.y0,x1:x,y1:y}); }
  drag=null; });
document.getElementById('cmd').addEventListener('keydown',ev=>{
  if(ev.key==='Enter'){ cmd(ev.target.value); ev.target.value=''; } ev.stopPropagation(); });
document.addEventListener('keydown',ev=>{
  if(ev.target.tagName==='INPUT') return;
  const k=ev.key;
  if(k==='9') cmd('next'); else if(k==='8') cmd('prev');
  else if(k===']') cmd('cam next'); else if(k==='[') cmd('cam prev');
  else if(k==='a') { addMode=!addMode; }
  else if(k==='r'&&sel!==null) cmd('delete '+sel);
  else if(k==='c'&&sel!==null) cmd('copy '+sel);
  else if(k==='p') cmd('paste');
  else if(k==='u') cmd('undo');
  else if(k==='w') cmd('save');
});
getState();
</script></body></html>
"""


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    from playground3d_tpu_torch.tools.annotator_shell import AnnotatorShell, session_from_csv
    from playground3d_tpu_torch.tools.annotator import AnnotationSession

    p = argparse.ArgumentParser(description="browser annotation GUI")
    p.add_argument("csv", help="46-column tracking CSV (or .npz session)")
    p.add_argument("--save", default=None)
    p.add_argument("--port", type=int, default=8008)
    args = p.parse_args(argv)
    sess = (
        AnnotationSession.load(args.csv)
        if args.csv.endswith(".npz")
        else session_from_csv(args.csv)
    )
    shell = AnnotatorShell(sess)
    shell.save_path = args.save or args.csv
    AnnotatorWeb(shell).serve_forever(port=args.port)


if __name__ == "__main__":  # pragma: no cover
    main()
