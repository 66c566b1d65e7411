"""Live training web server — interactive remote viewer + training control
(counterpart of lichtfeld_studio_tpu/render/live_server.py).

The reference visualizer runs the trainer on a jthread and drives it through
a state machine with pause/resume/save/stop controls while the render thread
draws the current model every frame (TrainerManager,
src/visualizer/training/training_manager.cpp:121-165; control atomics
trainer.hpp:199-216; render path src/rendering/rendering_pipeline.cpp:19).
A headless GPU box has no GLFW window, so the same capability is exposed
over HTTP instead:

  GET  /            orbit viewer page (drag to orbit, wheel to zoom) with
                    live stats and pause/resume/save/stop buttons
  GET  /state.json  {iteration, loss, num_gaussians, paused, status}
  GET  /render.png?yaw=&pitch=&r=&w=&h=   render the CURRENT model
  POST /control?cmd=pause|resume|save|stop

When the source is a StudioSession (render/studio.py — the CLI's
`--live-viewer PORT` with no -d/-v), the full application lifecycle of the
reference GUI (application.cpp:56-138) is exposed too:

  GET  /session.json  {mode, data_path, num_gaussians, train_error, ...}
  POST /open          {"path": "scene_dir | model.ply | model.sog"}
  POST /train         {"argv": ["-i","1000","--max-cap","100000", ...]}
  POST /crop          {"min": [x,y,z], "max": [x,y,z]}   (edit the model)
  POST /transform     {"translate": [x,y,z], "euler": [r,p,y]}
  POST /saveply       {"name": "cropped"}

Frames render through render/coherent.py's CoherentRenderer (one per
resolution, on the model's device): kernel P1 on its bin passes, kernel P2
on every frame. A render runs as a job on the trainer's thread between
dispatches (see render_png); a render error reaches the reply as 500 with
its message.
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.events import (
    PauseTraining,
    ResumeTraining,
    SaveCheckpoint,
    StopTraining,
    bus,
)


class _Job:
    """A unit of work to run on the trainer thread between dispatches
    (the headless analogue of the reference's render-mutex handoff,
    trainer.hpp:193: viewer frames must not race the training step. Adam
    and the strategies write the model's parameters in place on the
    trainer's stream, so a frame read from another thread mid-dispatch can
    see a half-written step)."""

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Exception | None = None
        self._claimed = False
        self._lock = threading.Lock()

    def claim(self) -> bool:
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def run(self, source) -> None:
        try:
            self.result = self.fn(source)
        except Exception as e:  # surface to the waiter, not the trainer loop
            self.error = e
        finally:
            self.done.set()


@dataclass
class TrainingControl:
    """Thread-safe control flags polled by Trainer.train between dispatches
    (the reference's pause_requested_/save_requested_/stop_requested_
    atomics, trainer.hpp:199-210). Commands also broadcast typed events on
    the bus (reference cmd:: namespace events, events.hpp:20-60)."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _paused: bool = False
    _stop: bool = False
    _save_requests: int = 0
    _jobs: list = field(default_factory=list)

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    @property
    def stop_requested(self) -> bool:
        with self._lock:
            return self._stop

    def pause(self) -> None:
        with self._lock:
            self._paused = True
        bus().emit(PauseTraining())

    def resume(self) -> None:
        with self._lock:
            self._paused = False
        bus().emit(ResumeTraining())

    def request_save(self) -> None:
        with self._lock:
            self._save_requests += 1
        bus().emit(SaveCheckpoint())

    def request_stop(self) -> None:
        with self._lock:
            self._stop = True
            self._paused = False
        bus().emit(StopTraining())

    def consume_save_request(self) -> bool:
        """Trainer-side: true once per queued save request."""
        with self._lock:
            if self._save_requests > 0:
                self._save_requests -= 1
                return True
            return False

    def reset(self) -> None:
        """Clear flags before a NEW run reuses this control (a studio
        session can train repeatedly; a previous run's stop flag must not
        kill the next one). Queued jobs survive — they target the model,
        not the run."""
        with self._lock:
            self._paused = False
            self._stop = False
            self._save_requests = 0

    # --- between-dispatch work queue ----------------------------------
    def submit(self, fn) -> _Job:
        """Queue fn(source) to run on the trainer thread between dispatches
        (where the model pytree is guaranteed live — see _Job)."""
        job = _Job(fn)
        with self._lock:
            self._jobs.append(job)
        return job

    def run_pending(self, source) -> None:
        """Trainer-side: execute queued jobs against the current state."""
        with self._lock:
            jobs, self._jobs = self._jobs, []
        for job in jobs:
            if job.claim():
                job.run(source)


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LichtFeld Studio — live training</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;font-family:monospace}
 #wrap{display:flex;height:100%}
 #view{flex:1;display:flex;align-items:center;justify-content:center;overflow:hidden}
 #img{max-width:100%;max-height:100%;cursor:grab;user-select:none}
 #side{width:260px;padding:12px;background:#1a1a1a;font-size:13px;line-height:1.7}
 button{margin:2px;padding:4px 10px;background:#333;color:#ddd;border:1px solid #555;
   cursor:pointer;font-family:monospace} button:hover{background:#444}
 .v{color:#9f9} h3{margin:6px 0;color:#fff;font-size:14px}
</style></head><body><div id="wrap">
<div id="view"><img id="img" draggable="false"></div>
<div id="side">
 <h3>training</h3>
 <div>iter <span class="v" id="it">-</span></div>
 <div>loss <span class="v" id="loss">-</span></div>
 <div>gaussians <span class="v" id="ng">-</span></div>
 <div>status <span class="v" id="st">-</span></div>
 <div style="margin-top:8px">
  <button onclick="ctl('pause')">pause</button><button onclick="ctl('resume')">resume</button>
  <button onclick="ctl('save')">save ply</button><button onclick="ctl('stop')">stop</button>
 </div>
 <h3 style="margin-top:14px">view</h3>
 <div>drag = orbit, wheel = zoom</div>
 <div>fps <span class="v" id="fps">-</span></div>
 <div id="studio" style="display:none">
  <h3 style="margin-top:14px">session <span class="v" id="mode">-</span></h3>
  <input id="path" placeholder="dataset dir or model.ply" style="width:95%">
  <button onclick="openPath()">open</button>
  <div style="margin-top:6px">
   <input id="targs" placeholder='-i 1000 --max-cap 100000'
          style="width:95%">
   <button onclick="train()">start training</button>
  </div>
  <h3 style="margin-top:10px">edit</h3>
  <div>crop min/max (x y z):</div>
  <input id="cmin" value="-1 -1 -1" style="width:44%">
  <input id="cmax" value="1 1 1" style="width:44%">
  <button onclick="crop()">crop</button>
  <div style="margin-top:6px">
   <input id="sname" placeholder="save name" style="width:60%">
   <button onclick="saveply()">save ply</button>
  </div>
  <div id="msg" style="color:#fa8"></div>
 </div>
</div></div>
<script>
"use strict";
let yaw=0, pitch=-0.2, r=1.0, dragging=false, lx=0, ly=0, pending=false, t0=0;
const img=document.getElementById("img");
function refresh(){
 if(pending)return; pending=true; t0=performance.now();
 const u=`/render.png?yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}&r=${r.toFixed(3)}&t=${Date.now()}`;
 const pre=new Image();
 pre.onload=()=>{img.src=pre.src;pending=false;
  document.getElementById("fps").textContent=(1000/(performance.now()-t0)).toFixed(1);};
 pre.onerror=()=>{pending=false;};
 pre.src=u;
}
img.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>{dragging=false;};
window.onmousemove=e=>{if(!dragging)return;
 yaw+=(e.clientX-lx)*0.01; pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-ly)*0.01));
 lx=e.clientX;ly=e.clientY;refresh();};
img.onwheel=e=>{e.preventDefault();r*=Math.exp(e.deltaY*0.001);r=Math.max(0.1,Math.min(10,r));refresh();};
function ctl(cmd){fetch("/control?cmd="+cmd,{method:"POST"});}
async function verb(path,body){
 const r=await fetch(path,{method:"POST",body:JSON.stringify(body)});
 const j=await r.json().catch(()=>({}));
 document.getElementById("msg").textContent=r.ok?JSON.stringify(j):(j.error||"error");
 if(r.ok)refresh(); return r.ok;
}
function openPath(){verb("/open",{path:document.getElementById("path").value});}
function train(){
 const a=document.getElementById("targs").value.trim();
 verb("/train",{argv:a?a.split(/\\s+/):[]});
}
function vec(id){return document.getElementById(id).value.trim().split(/\\s+/).map(Number);}
function crop(){verb("/crop",{min:vec("cmin"),max:vec("cmax")});}
function saveply(){verb("/saveply",{name:document.getElementById("sname").value});}
async function sess(){
 try{const r=await fetch("/session.json"); if(!r.ok)return;
  const s=await r.json();
  document.getElementById("studio").style.display="block";
  document.getElementById("mode").textContent=s.mode+
    (s.train_error?" ("+s.train_error+")":"");
 }catch(e){} setTimeout(sess,2000);
}
sess();
async function stats(){
 try{const s=await (await fetch("/state.json")).json();
  document.getElementById("it").textContent=s.iteration;
  document.getElementById("loss").textContent=s.loss==null?"-":s.loss.toFixed(4);
  document.getElementById("ng").textContent=s.num_gaussians;
  document.getElementById("st").textContent=s.status;
 }catch(e){}
 setTimeout(stats,1000);
}
setInterval(()=>{if(!dragging)refresh();},2000);
refresh(); stats();
</script></body></html>
"""


class LiveTrainingServer:
    """Serve the live viewer/controls for a running Trainer.

    `source` is any object with `.state.splats` (a SplatData) — normally the
    Trainer — plus optional `last_progress` (iteration, loss, n) the trainer
    maintains. The server owns a TrainingControl the trainer polls.
    """

    def __init__(self, source, control: TrainingControl | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.source = source
        self.control = control or TrainingControl()
        self._render_lock = threading.Lock()  # one in-flight render at a time
        self._coherent = {}  # (w, h) -> CoherentRenderer (frame-coherent bins)
        # lifecycle endpoints are live only when the source is a session
        from lichtfeld_studio_tpu_torch.render.studio import StudioSession

        self.session = source if isinstance(source, StudioSession) else None

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif u.path == "/state.json":
                        self._send(200, json.dumps(server.state_json()).encode(),
                                   "application/json")
                    elif u.path == "/render.png":
                        q = {k: v[0] for k, v in parse_qs(u.query).items()}
                        png = server.render_png(
                            yaw=float(q.get("yaw", 0.0)),
                            pitch=float(q.get("pitch", -0.2)),
                            rscale=float(q.get("r", 1.0)),
                            width=int(q.get("w", 640)),
                            height=int(q.get("h", 480)),
                        )
                        self._send(200, png, "image/png")
                    elif u.path == "/session.json":
                        sess = server.session
                        if sess is None:
                            self._send(404, b"no session", "text/plain")
                        else:
                            self._send(200, json.dumps(sess.session_json()).encode(),
                                       "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # keep the server alive on bad frames
                    self._send(500, str(e).encode(), "text/plain")

            def _json_body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                return json.loads(raw) if raw else {}

            def do_POST(self):
                u = urlparse(self.path)
                if u.path == "/control":
                    cmd = parse_qs(u.query).get("cmd", [""])[0]
                    ok = server.apply_command(cmd)
                    self._send(200 if ok else 400,
                               json.dumps({"ok": ok, "cmd": cmd}).encode(),
                               "application/json")
                    return
                sess = server.session
                verbs = {"/open", "/train", "/crop", "/transform", "/saveply"}
                if u.path not in verbs:
                    self._send(404, b"not found", "text/plain")
                    return
                if sess is None:
                    self._send(404, b"no session (start with --live-viewer "
                                    b"and no -d/-v)", "text/plain")
                    return
                try:
                    body = self._json_body()
                    if u.path == "/open":
                        res = sess.open(str(body.get("path", "")))
                    elif u.path == "/train":
                        res = sess.start_training(
                            [str(a) for a in body.get("argv", [])], server.control
                        )
                    elif u.path == "/crop":
                        res = sess.crop(body["min"], body["max"])
                    elif u.path == "/transform":
                        res = sess.transform(
                            body.get("translate"), body.get("euler")
                        )
                    else:
                        res = sess.save(str(body.get("name", "")))
                    self._send(200, json.dumps(res).encode(), "application/json")
                except Exception as e:  # lifecycle errors -> clean 409
                    self._send(409, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode(), "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    # ------------------------------------------------------------------
    def start(self) -> "LiveTrainingServer":
        self._thread.start()
        print(f"[viewer] live training viewer at http://127.0.0.1:{self.port}/",
              flush=True)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------------
    def apply_command(self, cmd: str) -> bool:
        c = self.control
        actions = {"pause": c.pause, "resume": c.resume,
                   "save": c.request_save, "stop": c.request_stop}
        if cmd not in actions:
            return False
        actions[cmd]()
        return True

    def state_json(self) -> dict:
        it, loss, n = getattr(self.source, "last_progress", (0, None, 0))
        c = self.control
        if self.session is not None and not self.session.training_active:
            status = self.session.mode
        else:
            status = ("stopping" if c.stop_requested
                      else "paused" if c.paused else "training")
        return {
            "iteration": it,
            "loss": loss,
            "num_gaussians": n,
            "status": status,
            "paused": c.paused,
        }

    def render_png(self, yaw: float, pitch: float, rscale: float,
                   width: int, height: int) -> bytes:
        """Render the current model. The render runs on the TRAINER thread
        between dispatches: Adam and the strategies write the parameters in
        place on the trainer's stream, so a frame taken from this HTTP
        thread mid-dispatch could read a half-written step (the reference
        serialises viewer frames against the step with a shared_mutex for
        the same reason, trainer.hpp:193). We queue a job the trainer runs
        at its next boundary; if nothing picks it up (viewer without an
        active training loop, or training finished), claim and run it here
        — the model is quiescent then."""
        from PIL import Image

        def do_render(source) -> np.ndarray:
            from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
            from lichtfeld_studio_tpu_torch.render.coherent import CoherentRenderer

            splats = source.state.splats
            n = max(int(splats.n_active), 1)
            with torch.no_grad():
                center = splats.means[:n].mean(0).cpu().numpy().astype(np.float64)
            radius = rscale * 2.5 * max(float(splats.scene_scale), 1e-3)
            cp, sp = np.cos(pitch), np.sin(pitch)
            eye = center + radius * np.array(
                [cp * np.sin(yaw), sp, cp * np.cos(yaw)]
            )
            cam = look_at_camera(
                eye, center, np.array([0.0, -1.0, 0.0]),
                fx=0.8 * width, fy=0.8 * width, width=width, height=height,
            )
            # frame-coherent renderer per resolution: consecutive orbit
            # frames of a STATIC model (paused/finished run, or between
            # dispatches) reuse one tile binning; a new model object or an
            # in-place write (SplatData.version) re-bins
            key = (width, height)
            r = self._coherent.get(key)
            if r is None:
                r = self._coherent[key] = CoherentRenderer(
                    width, height, instance_cap=2 ** 18
                )
            return r.render(splats, cam)

        with self._render_lock:
            job = self.control.submit(do_render)
            # Self-claim ONLY when no training loop is pumping the queue
            # (static viewer / finished run): while training is active, the
            # trainer writes the model in place, and reading it from here
            # races those writes.
            if not getattr(self.source, "training_active", False):
                if job.claim():
                    job.run(self.source)
            if not job.done.wait(timeout=600.0):
                raise TimeoutError("render did not complete")
        if job.error is not None:
            raise job.error
        buf = io.BytesIO()
        Image.fromarray(job.result).save(buf, format="PNG")
        return buf.getvalue()
