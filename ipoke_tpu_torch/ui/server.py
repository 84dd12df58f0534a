"""Interactive poke UI (counterpart of ``ipoke_tpu/ui/server.py``;
reference ``testing/gui.py``, PyQt5, rebuilt as a stdlib web app).

Serves a canvas with a start frame; a mouse drag is a poke (position and
displacement): the server stamps the poke map (the training ``poke_size``
window), runs the second stage's ``forward_sample`` on the experiment's
device and returns the frames as base64 PNGs for playback.

    python -m ipoke_tpu_torch.ui.server --config <second_stage yaml>
        --model_name <name> [--data_root DIR] [--port 8000]
        [--display_size 256] [--device cuda|cpu]

Endpoints: GET / (page), GET /frame (a new start frame), POST /poke
({x, y, dx, dy}, normalised to the display) -> {frames: [b64 png, ...]},
POST /save -> {files: [...]}: the current video as mp4 and enrollment PNG
under ``<generated>/gui/id_<k>/`` and, once per start frame, the ground
truth clip and ``n_gt_pokes`` dataset-simulated ground-truth pokes run
through the model (reference ``testing/gui.py:217-320``).  The run is
restored as the ``--test`` modes restore it (``cli.testing.
_restore_trained``: best checkpoint, a mixed run upcast to fp32); TF32 is
off.  ``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>ipoke_tpu — interactive poke</title><style>
body{font-family:sans-serif;background:#111;color:#eee;text-align:center}
canvas{image-rendering:pixelated;border:1px solid #555;cursor:crosshair}
button{margin:8px}
</style></head><body>
<h3>ipoke_tpu — drag on the image to poke</h3>
<canvas id=c width=%(disp)d height=%(disp)d></canvas><br>
<button onclick="newFrame()">new frame</button>
<button onclick="saveVid()">save video</button>
<span id=status></span>
<script>
const S=%(disp)d, c=document.getElementById('c'), ctx=c.getContext('2d');
let frames=[], playing=null, start=null, x0=null;
function draw(img64){const im=new Image();im.onload=()=>ctx.drawImage(im,0,0,S,S);
  im.src='data:image/png;base64,'+img64;}
function newFrame(){fetch('/frame').then(r=>r.json()).then(d=>{x0=d.frame;draw(x0);});}
function saveVid(){fetch('/save',{method:'POST',body:'{}'}).then(r=>r.json()).then(d=>{
  document.getElementById('status').textContent=d.error||('saved '+d.files.length+' files');});}
c.onmousedown=e=>{const r=c.getBoundingClientRect();start=[e.clientX-r.left,e.clientY-r.top];};
c.onmouseup=e=>{if(!start)return;const r=c.getBoundingClientRect();
 const end=[e.clientX-r.left,e.clientY-r.top];
 const body={x:start[0]/S,y:start[1]/S,dx:(end[0]-start[0])/S,dy:(end[1]-start[1])/S};
 start=null;document.getElementById('status').textContent='generating...';
 fetch('/poke',{method:'POST',body:JSON.stringify(body)}).then(r=>r.json()).then(d=>{
   frames=d.frames;let i=0;clearInterval(playing);
   playing=setInterval(()=>{draw(frames[i]);i=(i+1)%%frames.length;},200);
   document.getElementById('status').textContent='';});};
newFrame();
</script></body></html>"""


def _png_b64(img_u8: np.ndarray) -> str:
    import cv2

    ok, buf = cv2.imencode(".png", img_u8[..., ::-1])
    return base64.b64encode(buf.tobytes()).decode()


def _display_png(img: np.ndarray, size: int) -> str:
    """A [-1, 1] (H, W, 3) frame as a ``size`` px PNG (nearest neighbour)."""
    import cv2

    u8 = ((img + 1) * 127.5).clip(0, 255).astype(np.uint8)
    return _png_b64(cv2.resize(u8, (size, size), interpolation=cv2.INTER_NEAREST))


class PokeSession:
    """The experiment and a current start batch (item 0 of a test batch, on
    the experiment's device); turns pokes into videos."""

    def __init__(self, experiment, display_size: int = 256,
                 save_root: Optional[str] = None, n_gt_pokes: int = 3):
        self.experiment = experiment
        self.display_size = display_size
        data = experiment.config["data"]
        self.spatial = data["spatial_size"][0]
        self.T = data["max_frames"]
        self.poke_size = int(data.get("poke_size", 5))
        self.n_gt_pokes = int(experiment.config.get("ui", {}).get("n_gt_pokes", n_gt_pokes))
        self.save_root = save_root or (
            experiment.dirs["generated"] if getattr(experiment, "dirs", None)
            else os.path.join(os.getcwd(), "generated"))
        self._loader = None
        self.batch = None
        self.frame_id = -1
        self.save_count = 0
        self.current = None  # the last generated {vid, poke} for /save
        self.new_frame()

    def new_frame(self) -> str:
        if self._loader is None:
            self._loader = iter(self.experiment.datamodule.test_loader(n_batches=10**6))
        try:
            b = next(self._loader)
        except StopIteration:
            self._loader = None
            return self.new_frame()
        dev = self.experiment.device
        self.batch = {k: torch.as_tensor(np.ascontiguousarray(v[:1])).to(dev)
                      for k, v in b.items()}
        self.frame_id += 1
        self.save_count = 0
        self.current = None
        return self.frame_png()

    def frame_png(self) -> str:
        return _display_png(self.batch["images"][0, 0].float().cpu().numpy(),
                            self.display_size)

    def _sample(self, poke: np.ndarray) -> np.ndarray:
        """One ``forward_sample`` pass from the current frame under the
        (H, W, 2) ``poke``: (T, H, W, 3) fp32 on the host."""
        from ..cli.testing import _sampling_batch

        e = self.experiment
        batch = dict(self.batch, poke=torch.from_numpy(poke[None]).to(e.device))
        with torch.no_grad():
            vid = e.model.forward_sample(_sampling_batch(batch), self.T, e.generator)
        return vid[0].float().cpu().numpy()

    def poke(self, x: float, y: float, dx: float, dy: float):
        """Position and displacement normalised to [0, 1] of the display."""
        S = self.spatial
        r, c = int(np.clip(y * S, 0, S - 1)), int(np.clip(x * S, 0, S - 1))
        # displacement in input pixels (reference gui.py:326-350 rescales by
        # the display/input ratio)
        vec = np.asarray([dx * S, dy * S], np.float32)
        poke = np.zeros((S, S, 2), np.float32)
        half = self.poke_size // 2
        poke[max(0, r - half): r + half + 1, max(0, c - half): c + half + 1] = vec
        frames = self._sample(poke)
        self.current = {"vid": frames, "poke": poke}
        return [_display_png(f, self.display_size) for f in frames]

    # -- save / GT-poke parity (reference testing/gui.py:217-320) ----------

    def _padded_video(self, x0, vid, poke, n_pad: int = 4):
        """[x0 with poke arrows] x n_pad, the clip, its last frame x n_pad
        (reference ``make_padded_video``)."""
        from ..utils.video import draw_poke_arrows, to_uint8

        src = draw_poke_arrows(to_uint8(x0), poke)
        return np.concatenate([np.stack([src] * n_pad), to_uint8(vid),
                               np.stack([to_uint8(vid[-1])] * n_pad)])

    def _write(self, video, path, files):
        from ..utils.video import save_enrollment, save_video

        save_video(video, path)
        files.append(path)
        files.append(save_enrollment(video, path[:-4] + "_enrollment.png",
                                     max_frames=len(video)))

    def save_current(self):
        """The last generated video as mp4 and enrollment under
        ``<generated>/gui/id_<frame>/``; on the first save of a start frame
        also the ground-truth clip and the ground-truth pokes' videos."""
        if self.current is None:
            raise ValueError("no video was generated yet — poke first")
        base = os.path.join(self.save_root, "gui", f"id_{self.frame_id}")
        os.makedirs(base, exist_ok=True)
        x0 = self.batch["images"][0, 0].float().cpu().numpy()
        files = []
        out = self._padded_video(x0, self.current["vid"], self.current["poke"])
        self._write(out, os.path.join(base, f"vid_{self.save_count}.mp4"), files)
        if self.save_count == 0:
            files += self._save_gt_pokes(base)
        self.save_count += 1
        return files

    def _save_gt_pokes(self, base: str):
        """The ground-truth clip and ``n_gt_pokes`` dataset-simulated pokes
        of its flow through the model (reference ``generate_gt_poke_vid``,
        gui.py:217-280)."""
        from ..data.poke import simulate_poke
        from ..utils.video import to_uint8

        files = []
        imgs = self.batch["images"][0].float().cpu().numpy()  # (T+1, H, W, 3)
        gt_pad = np.concatenate([np.stack([to_uint8(imgs[0])] * 8), to_uint8(imgs),
                                 np.stack([to_uint8(imgs[-1])] * 4)])
        self._write(gt_pad, os.path.join(base, "gt_vid.mp4"), files)
        if "flow" not in self.batch or self.n_gt_pokes <= 0:
            return files  # no ground-truth flow (e.g. encoder-only runs)
        flow = self.batch["flow"][0].float().cpu().numpy()
        rng = np.random.default_rng(self.frame_id)
        for i in range(self.n_gt_pokes):
            gt_poke, _ = simulate_poke(flow, rng, n_pokes_max=1, poke_size=self.poke_size)
            out = self._padded_video(imgs[0], self._sample(gt_poke), gt_poke)
            self._write(out, os.path.join(base, f"gt_poke_vid_{i}.mp4"), files)
        return files


def make_handler(session: PokeSession):
    lock = threading.Lock()  # one request at a time drives the session

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, payload, ctype="application/json"):
            body = payload.encode() if isinstance(payload, str) else payload
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(_PAGE % {"disp": session.display_size}, "text/html")
            elif self.path == "/frame":
                with lock:
                    frame = session.new_frame()
                self._send(json.dumps({"frame": frame}))
            else:
                self.send_error(404)

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path == "/poke":
                req = json.loads(body)
                with lock:
                    frames = session.poke(req["x"], req["y"], req["dx"], req["dy"])
                self._send(json.dumps({"frames": frames}))
            elif self.path == "/save":
                try:
                    with lock:
                        files = session.save_current()
                    self._send(json.dumps({"files": files}))
                except ValueError as e:
                    self._send(json.dumps({"files": [], "error": str(e)}))
            else:
                self.send_error(404)

    return Handler


def serve(experiment, port: int = 8000, display_size: int = 256,
          background: bool = False, save_root: Optional[str] = None
          ) -> Optional[ThreadingHTTPServer]:
    """Serve ``experiment`` on 127.0.0.1:``port`` (0: any free port); with
    ``background`` the server runs in a daemon thread and is returned (stop
    it with ``shutdown()``)."""
    session = PokeSession(experiment, display_size, save_root=save_root)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(session))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"ipoke_tpu_torch UI on http://127.0.0.1:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ipoke_tpu_torch interactive poke UI")
    p.add_argument("--config", required=True)
    p.add_argument("--model_name", required=True)
    p.add_argument("--data_root", default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--display_size", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_experiment(args):
    """The run of ``--config`` / ``--model_name``, built and restored on
    ``--device`` (``main.load_parameters``, ``select_experiment``,
    ``cli.testing._restore_trained``), TF32 off."""
    from .. import main as cli
    from ..cli.experiments import select_experiment
    from ..cli.testing import _restore_trained

    cli.check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, dirs, data_root = cli.load_parameters(argparse.Namespace(
        config=args.config, model_name=args.model_name, test="samples", resume=False,
        last_ckpt=False, target_version=None, data_root=args.data_root, debug=False))
    experiment = select_experiment(config)(config, dirs, data_root=data_root,
                                           device=args.device)
    _restore_trained(experiment)
    return experiment


def main(argv=None):
    args = parse_args(argv)
    serve(load_experiment(args), args.port, args.display_size)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
