"""Synchronized multi-camera playback of a tracked session — the browser
scrubber (reference datareader.py:294-345 ``plot_in``).

A numpy copy of ``playground3d_tpu/tools/playback_web.py`` with its imports pointed
at the port's modules.

The reference plays N camera videos side by side, advancing each camera to
the frame whose (timestamp + per-camera clock bias) is nearest a shared
master clock, and rolls every tracked state forward at constant velocity to
that camera's exact corrected frame time before projecting it into the view
(rollforward at datareader.py:343-345). This module reproduces that
synchronized-playback semantic headlessly:

* :class:`SyncPlayback` is the pure core — master clock in, per-camera
  (frame index, corrected time, rolled-forward states, projected corners)
  out — unit-testable without HTTP;
* :class:`PlaybackWeb` serves it as a single-page scrubber: one canvas per
  camera, a master-clock range slider, and a play button, over the repo's
  own ``http.server`` + PNG codec (no third-party stack, same design as
  :mod:`annotator_web`).

Frames are optional: with a ``frame_fn`` the canvases show real video with
overlaid boxes; without one the overlays render on black, which still gives
the synchronized trajectory review the reference tool is used for.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.evaluation.datareader import TimeIndexedTracks, states_at


class SyncPlayback:
    """Master-clock synchronized view over N cameras of one tracked session.

    Parameters
    ----------
    tracks: the time-indexed tracking CSV (shared roadway clock).
    registry: CameraRegistry with every camera's banked P matrices.
    cameras: camera names, in display order.
    cam_times: per camera, the sorted RAW frame timestamps of its video.
    biases: per-camera clock bias (ts + bias = shared clock), the online
        EMA estimate the tracker writes (reference estimate_ts_bias,
        MC3D_crop_tracker.py:237-315); defaults to 0.
    frame_fn: optional (frame_idx, camera) -> [H,W,3] float/uint8 image.
    """

    def __init__(
        self,
        tracks: TimeIndexedTracks,
        registry,
        cameras: Sequence[str],
        cam_times: Dict[str, np.ndarray],
        biases: Optional[Dict[str, float]] = None,
        frame_fn: Optional[Callable[[int, str], np.ndarray]] = None,
        max_extrapolate: float = 0.5,
    ):
        self.tracks = tracks
        self.registry = registry
        self.cameras = list(cameras)
        self.cam_times = {c: np.asarray(cam_times[c], np.float64) for c in cameras}
        self.biases = {c: float((biases or {}).get(c, 0.0)) for c in cameras}
        self.frame_fn = frame_fn
        self.max_extrapolate = float(max_extrapolate)

    def span(self):
        """Master-clock range covered by every camera's corrected video."""
        lo = max(self.cam_times[c][0] + self.biases[c] for c in self.cameras)
        hi = min(self.cam_times[c][-1] + self.biases[c] for c in self.cameras)
        return float(lo), float(hi)

    def frame_at(self, camera: str, t_master: float) -> int:
        """Index of the camera frame whose corrected time is nearest the
        master clock (the reference's per-camera advance loop)."""
        ts = self.cam_times[camera] + self.biases[camera]
        k = int(np.searchsorted(ts, t_master))
        if k <= 0:
            return 0
        if k >= len(ts):
            return len(ts) - 1
        return k if ts[k] - t_master < t_master - ts[k - 1] else k - 1

    def view_at(self, t_master: float) -> List[dict]:
        """Per-camera synchronized view at one master-clock instant."""
        out = []
        for cam in self.cameras:
            k = self.frame_at(cam, t_master)
            # states roll forward to the camera's CORRECTED frame time, so
            # each view shows the trajectory exactly where that camera's
            # shutter saw it (reference rollforward, datareader.py:343-345)
            t_cam = float(self.cam_times[cam][k] + self.biases[cam])
            ids, states = states_at(self.tracks, t_cam, self.max_extrapolate)
            entry = {
                "camera": cam,
                "frame_idx": k,
                "t_frame": t_cam,
                "ids": ids,
                "states": states,
                "classes": [self.tracks.classes.get(i, "") for i in ids],
                "corners_px": np.zeros((0, 8, 2)),
            }
            if len(ids) and self.registry is not None:
                c = self.registry.index(cam)
                entry["corners_px"] = G.state_to_im_banked(
                    states, self.registry.P[c, 0], self.registry.P[c, 1]
                )
            out.append(entry)
        return out

    # -- rendering -------------------------------------------------------------
    def frame_png(
        self, camera: str, t_master: float, height: int = 1080, width: int = 1920
    ) -> bytes:
        from playground3d_tpu_torch.data.video import encode_png
        from playground3d_tpu_torch.tools.visualize import plot_boxes

        view = self.view_at(t_master)[self.cameras.index(camera)]
        if self.frame_fn is not None:
            frame = np.asarray(
                self.frame_fn(view["frame_idx"], camera), np.float32
            )
            if frame.max() > 1.5:
                frame = frame / 255.0
        else:
            frame = np.zeros((height, width, 3), np.float32)
        if len(view["corners_px"]):
            frame = plot_boxes(frame, np.asarray(view["corners_px"], np.float64))
        return encode_png(frame)


class PlaybackWeb:
    """HTTP scrubber over one :class:`SyncPlayback`."""

    def __init__(self, playback: SyncPlayback):
        self.pb = playback
        self._lock = threading.Lock()

    def view_json(self, t_master: float) -> dict:
        lo, hi = self.pb.span()
        views = []
        for v in self.pb.view_at(t_master):
            views.append(
                {
                    "camera": v["camera"],
                    "frame_idx": v["frame_idx"],
                    "t_frame": round(v["t_frame"], 4),
                    "ids": [int(i) for i in v["ids"]],
                    "classes": v["classes"],
                    "states": [
                        [round(float(x), 3) for x in s] for s in np.asarray(v["states"])
                    ],
                }
            )
        return {"t": t_master, "span": [lo, hi], "cameras": views}

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

            def _q(self):
                from urllib.parse import parse_qs, urlparse

                return {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}

            def do_GET(self):
                with web._lock:
                    try:
                        if self.path == "/" or self.path.startswith("/index"):
                            lo, hi = web.pb.span()
                            page = PAGE.replace("__CAMS__", json.dumps(web.pb.cameras))
                            page = page.replace("__LO__", repr(lo)).replace(
                                "__HI__", repr(hi)
                            )
                            self._send(200, page.encode(), "text/html; charset=utf-8")
                        elif self.path.startswith("/view"):
                            t = float(self._q().get("t", web.pb.span()[0]))
                            self._send(
                                200,
                                json.dumps(web.view_json(t)).encode(),
                                "application/json",
                            )
                        elif self.path.startswith("/pframe.png"):
                            q = self._q()
                            t = float(q.get("t", web.pb.span()[0]))
                            cam = q.get("cam", web.pb.cameras[0])
                            self._send(200, web.pb.frame_png(cam, t), "image/png")
                        else:
                            self._send(404, b"not found", "text/plain")
                    except Exception as e:  # keep the session alive on bad input
                        self._send(
                            400, json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8009) -> None:
        srv = self.make_server(host, port)
        print(f"playback scrubber: http://{host}:{srv.server_address[1]}/")
        srv.serve_forever()


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>synchronized playback</title>
<style>
 body{background:#14141e;color:#d8d8e0;font:13px monospace;margin:0;padding:10px}
 #grid{display:flex;flex-wrap:wrap;gap:8px}
 .cell{display:flex;flex-direction:column}
 .cell img{max-width:46vw;border:1px solid #333}
 .cap{color:#7fd1b9;padding:2px 0}
 #bar{display:flex;gap:10px;align-items:center;padding:8px 0}
 input[type=range]{flex:1}
 button{background:#1e1e2a;color:#d8d8e0;border:1px solid #444;padding:4px 12px}
</style></head><body>
<div id="bar">
 <button id="play">play</button>
 <input type="range" id="scrub" min="__LO__" max="__HI__" step="0.0333" value="__LO__">
 <span id="clock"></span>
</div>
<div id="grid"></div>
<script>
const CAMS=__CAMS__; let playing=false, t=__LO__;
const grid=document.getElementById('grid'), scrub=document.getElementById('scrub');
for(const c of CAMS){ grid.insertAdjacentHTML('beforeend',
  `<div class="cell"><img id="im_${c}"><div class="cap" id="cap_${c}">${c}</div></div>`); }
async function show(tq){
  t=tq; scrub.value=t;
  const v=await (await fetch('/view?t='+t)).json();
  document.getElementById('clock').textContent='t='+t.toFixed(3)+'s';
  for(const cv of v.cameras){
    document.getElementById('im_'+cv.camera).src='/pframe.png?cam='+cv.camera+'&t='+t+'&_='+Date.now();
    document.getElementById('cap_'+cv.camera).textContent=
      `${cv.camera} · frame ${cv.frame_idx} · t ${cv.t_frame.toFixed(3)} · ${cv.ids.length} tracks`;
  }
}
scrub.addEventListener('input',ev=>{ playing=false; show(parseFloat(ev.target.value)); });
document.getElementById('play').addEventListener('click',async ()=>{
  playing=!playing;
  while(playing){ const nt=t+1/30; if(nt>parseFloat(scrub.max)){playing=false;break;}
    await show(nt); await new Promise(r=>setTimeout(r,33)); }
});
show(__LO__);
</script></body></html>
"""


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(description="synchronized multi-camera scrubber")
    p.add_argument("csv", help="46-column tracking CSV")
    p.add_argument("--cameras", nargs="+", default=["p1c1"])
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--port", type=int, default=8009)
    args = p.parse_args(argv)
    tracks = TimeIndexedTracks.from_csv(args.csv)
    lo, hi = tracks.span()
    # without the original videos, synthesize each camera's frame clock at
    # the nominal rate over the tracked span (overlays render on black)
    ts = np.arange(lo, hi + 1e-9, 1.0 / args.fps)
    pb = SyncPlayback(
        tracks, None, args.cameras, {c: ts for c in args.cameras}
    )
    PlaybackWeb(pb).serve_forever(port=args.port)


if __name__ == "__main__":  # pragma: no cover
    main()
