"""Interactive viewer — the counterpart of the reference's live GLFW window
(``--view path.ply``, main.mm:231-297, mtl_engine.mm:89-160,401-609).

An accelerator host has no display, so instead of a window this serves a small web
page: the browser sends orbit-camera state (drag = orbit, wheel = dolly,
shift-drag = pan) and the server renders each frame on demand through the
SAME depth-exact tiled pipeline used for training (ops/rasterize.py) — the
reference's viewer instead re-sorts splats globally per frame
(gpu_sort.mm:1-120); the tiled path needs no separate sort.

  python -m gaussiansplatting.tools.view --ply model.ply [--port 8000]
      [--width 800 --height 600] [--fov 60] [--sh-degree 0]

INTERACTIVE TRAINING (the reference's train-while-displaying run loop,
mtl_engine.mm:98-155): pass a COLMAP dataset instead of (or with) a PLY and
the page gains a "train" button + auto-train toggle that drive the real
train step — densify / opacity-reset events on the reference cadence —
between frames:

  python -m gaussiansplatting.tools.view --colmap scene/sparse/0 \
      --images scene/images [--checkpoint ckpt/latest.npz] [--iters 30000]

Then open http://localhost:8000/ (ssh -L 8000:localhost:8000 for remote).
One render resolution is compiled once; frames are PNG over HTTP.  On CPU
use small sizes.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>gaussiansplatting viewer</title><style>
  body { margin:0; background:#111; color:#ccc; font:13px monospace; }
  #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 8px;
         border-radius:4px; pointer-events:none; }
  img { display:block; margin:0 auto; image-rendering:auto; }
</style></head><body>
<div id="hud">drag = orbit · wheel = dolly · shift-drag = pan · loading…</div>
<div id="trainbar" style="position:fixed;top:8px;right:8px;background:#000a;
     padding:6px 8px;border-radius:4px;display:none">
  <button id="tbtn">train 100</button>
  <label><input type="checkbox" id="tauto"> auto</label>
  <span id="tinfo"></span>
</div>
<img id="v" draggable="false">
<script>
const img = document.getElementById('v'), hud = document.getElementById('hud');
let st = null, busy = false, dirty = true, training = false;
const tbtn = document.getElementById('tbtn'), tauto = document.getElementById('tauto'),
      tinfo = document.getElementById('tinfo');
function trainOnce(n) {
  if (training) return;
  training = true;
  fetch('/train?n=' + n).then(r => r.json()).then(j => {
    tinfo.textContent = ' it ' + j.iteration + ' loss ' + j.loss.toFixed(4) +
      ' n ' + j.num_gaussians;
    training = false; dirty = true;
    if (tauto.checked) setTimeout(() => trainOnce(n), 0);
  }).catch(() => { training = false; });
}
tbtn.addEventListener('click', () => trainOnce(100));
tauto.addEventListener('change', () => { if (tauto.checked) trainOnce(100); });
fetch('/state').then(r => r.json()).then(s => {
  st = s;
  if (s.trainable) document.getElementById('trainbar').style.display = 'block';
  tick();
});
function url() {
  return '/frame?az=' + st.az.toFixed(4) + '&el=' + st.el.toFixed(4) +
    '&r=' + st.r.toFixed(4) + '&cx=' + st.cx.toFixed(4) +
    '&cy=' + st.cy.toFixed(4) + '&cz=' + st.cz.toFixed(4);
}
function tick() {
  if (!st || busy || !dirty) { requestAnimationFrame(tick); return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  fetch(url()).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    hud.textContent = 'az ' + st.az.toFixed(2) + ' el ' + st.el.toFixed(2) +
      ' r ' + st.r.toFixed(2) + ' · ' + (performance.now() - t0).toFixed(0) + ' ms';
    busy = false; requestAnimationFrame(tick);
  }).catch(() => { busy = false; requestAnimationFrame(tick); });
}
let drag = null;
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY, e.shiftKey]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag || !st) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {      // pan in the camera's screen plane
    const s = st.r * 0.002;
    const ca = Math.cos(st.az), sa = Math.sin(st.az);
    st.cx += (-sa * -dx) * s; st.cz += (ca * -dx) * s; st.cy += dy * s;
  } else {
    st.az -= dx * 0.01;
    st.el = Math.max(-1.5, Math.min(1.5, st.el + dy * 0.01));
  }
  drag = [e.clientX, e.clientY, drag[2]]; dirty = true;
});
window.addEventListener('wheel', e => {
  if (!st) return;
  st.r = Math.max(0.05, st.r * Math.exp(e.deltaY * 0.001)); dirty = true;
});
</script></body></html>"""


class ViewerState:
    """Shared render state: params + compiled render fn + scene framing."""

    def __init__(self, params, cfg, width, height, fov_deg, center, radius):
        import jax

        from gaussiansplatting.ops.rasterize import render as raster_render

        self.params = params
        self.cfg = cfg
        self.width = width
        self.height = height
        self.fy = height / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
        self.center = center
        self.radius = radius
        self.lock = threading.Lock()  # one device program at a time
        self._render = jax.jit(raster_render, static_argnums=2)
        # interactive-training fields (attach_trainer)
        self.tstate = None
        self.cameras = None
        self.gts = None
        self.extent = 1.0
        self.total_iters = 30_000
        self.iteration = 0

    def attach_trainer(self, tstate, cameras, gts, extent, total_iters,
                       iteration=0):
        """Enable the train button: the viewer drives the REAL train step
        (densify/reset on the reference cadence) between frames, matching
        the reference's interactive-training branch (mtl_engine.mm:98-155)."""
        self.tstate = tstate
        self.cameras = cameras
        self.gts = gts
        self.extent = extent
        self.total_iters = total_iters
        self.iteration = iteration
        self.params = tstate.params

    def train(self, n: int) -> dict:
        """Run n train iterations (view order fixed, reference parity) and
        return the last step's scalar metrics."""
        from gaussiansplatting.train import trainer

        n = max(1, min(int(n), 1000))
        with self.lock:
            st = self.tstate
            metrics = None
            for _ in range(n):
                v = self.iteration % len(self.cameras)
                cam, gt = self.cameras[v], self.gts[v]
                st, metrics = trainer.train_step(
                    st, cam, gt, self.cfg, self.total_iters
                )
                self.iteration += 1
                if trainer.should_densify(self.iteration, self.cfg):
                    st, _ = trainer.densify_step(
                        st, self.extent, cam.fx, self.cfg
                    )
                if trainer.should_reset_opacity(self.iteration, self.cfg):
                    st = trainer.opacity_reset_step(st, self.cfg)
            self.tstate = st
            self.params = st.params
            return {
                "iteration": self.iteration,
                "loss": float(metrics.loss),
                "psnr": float(metrics.psnr),
                "num_gaussians": int(metrics.num_gaussians),
            }

    def frame_png(self, az, el, r, cx, cy, cz) -> bytes:
        from gaussiansplatting.core import camera as camera_mod
        from gaussiansplatting.io.images import encode_png

        cam = camera_mod.orbit_camera(
            np.array([cx, cy, cz], np.float32), r, azimuth=az, elevation=el,
            fx=self.fy, fy=self.fy, width=self.width, height=self.height,
        )
        with self.lock:
            img, _ = self._render(self.params, cam, self.cfg.raster)
            arr = np.asarray(img)
        # zlib level 1: a frame is encoded per request, speed over size
        return encode_png(
            np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8), level=1
        )


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif u.path == "/state":
                self._send(200, "application/json", json.dumps({
                    "az": 0.0, "el": 0.3, "r": state.radius,
                    "cx": float(state.center[0]),
                    "cy": float(state.center[1]),
                    "cz": float(state.center[2]),
                    "trainable": state.tstate is not None,
                }).encode())
            elif u.path == "/train":
                if state.tstate is None:
                    self._send(400, "application/json",
                               b'{"error": "no dataset attached"}')
                    return
                q = parse_qs(u.query)
                try:
                    n = int(q.get("n", ["100"])[0])
                except ValueError:
                    n = 100
                self._send(
                    200, "application/json",
                    json.dumps(state.train(n)).encode(),
                )
            elif u.path == "/frame":
                q = parse_qs(u.query)

                def f(k, d):
                    try:
                        return float(q[k][0])
                    except (KeyError, ValueError):
                        return d

                body = state.frame_png(
                    f("az", 0.0), f("el", 0.3), f("r", state.radius),
                    f("cx", state.center[0]), f("cy", state.center[1]),
                    f("cz", state.center[2]),
                )
                self._send(200, "image/png", body)
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def build_state(ply, width, height, fov, sh_degree, pair_capacity):
    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.core import gaussians as gaussians_mod
    from gaussiansplatting.io import ply as ply_mod

    cfg = Config(raster=RasterConfig(
        pair_capacity=pair_capacity, sh_degree=sh_degree
    ))
    cloud = ply_mod.load_gaussian_ply(ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities,
        cloud.sh,
    )
    center = cloud.means.mean(axis=0)
    spread = float(
        np.percentile(np.linalg.norm(cloud.means - center, axis=1), 90)
    )
    return ViewerState(
        params, cfg, width, height, fov, center, max(spread * 2.5, 1e-3)
    )


def build_training_state(args):
    """Dataset-backed viewer: params come from a checkpoint (if given) or
    SfM init, and the train button drives the real schedule."""
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.io.dataset import load_colmap_scene
    from gaussiansplatting.train import checkpoint as ckpt_mod
    from gaussiansplatting.train import state as state_mod

    cfg = Config(raster=RasterConfig(
        pair_capacity=args.pair_capacity, sh_degree=args.sh_degree
    ))
    scene = load_colmap_scene(
        args.colmap, args.images, cfg, downscale=args.downscale
    )
    iteration = 0
    if args.checkpoint:
        tstate, saved_cfg = ckpt_mod.load(args.checkpoint)
        if saved_cfg is not None:
            cfg = saved_cfg
        iteration = int(tstate.opt.t)
    else:
        tstate = state_mod.create(scene.params, seed=cfg.train.seed)

    params = tstate.params
    means = np.asarray(params.means)
    alive = np.asarray(params.alive)
    pts = means[alive] if alive.any() else means
    center = pts.mean(axis=0)
    spread = float(np.percentile(np.linalg.norm(pts - center, axis=1), 90))
    state = ViewerState(
        params, cfg, args.width, args.height, args.fov, center,
        max(spread * 2.5, 1e-3),
    )
    gts = [jax.device_put(g) for g in scene.gt_images]
    state.attach_trainer(
        tstate, scene.cameras, gts, scene.extent, args.iters, iteration
    )
    return state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", default=None, help="view a PLY (no training)")
    p.add_argument("--colmap", default=None,
                   help="COLMAP sparse dir — enables interactive training")
    p.add_argument("--images", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="resume training state from this .npz")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--iters", type=int, default=30_000,
                   help="total-iteration horizon for the LR schedule")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1))
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.colmap:
        if not args.images:
            raise SystemExit("error: --colmap needs --images")
        state = build_training_state(args)
    elif args.ply:
        state = build_state(
            args.ply, args.width, args.height, args.fov, args.sh_degree,
            args.pair_capacity,
        )
    else:
        raise SystemExit("error: pass --ply or --colmap/--images")
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"viewer at http://localhost:{args.port}/ "
          f"({state.width}x{state.height}, n={int(np.asarray(state.params.alive).sum())})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
