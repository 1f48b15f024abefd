"""Progressive render preview with an interactive camera — the mtsgui
role, browser-native (port of mitsuba_tpu/preview.py).

The reference ships a Qt GUI (src/mtsgui) whose core loop is a
progressively refining render view with mouse camera control
(preview.h:34, the glwidget.cpp mouse handlers: left-drag orbits,
wheel dollies, middle/right-drag pans, and any camera motion restarts
the progressive accumulation).  This serves the same loop over HTTP:

    python -m mitsuba_tpu_torch.preview scenes/cbox.xml --port 8731

renders pass after pass (running average), serves a live page with the
current image, and accepts camera moves from the browser: left-drag =
orbit, wheel = dolly, shift/right-drag = pan, `r` = reset.  A camera
move updates the sensor transform (no scene re-pack — only the
camera-derived `cam_w2c` array changes) and restarts accumulation,
exactly like the reference preview re-seeding its VPL render when the
view changes.  The passes run on the card unless `--cpu` (or
`device="cpu"`) asks for the CPU.

The renderer loop (`progressive_render`) and the camera model
(`CameraRig`) are importable and run headless for testing.  Each pass of
`progressive_render` is the image of `render(scene, spp=spp_chunk,
seed=pass index)`: each pass is one call of `render` on the scene's
pack.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import threading
import time
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch


def _tonemap(img):
    return np.clip(np.asarray(img) ** (1.0 / 2.2), 0.0, 1.0)


class CameraRig:
    """Orbit/dolly/pan camera state (the mtsgui preview camera).

    Decomposes the sensor's to_world into an orbit around a target
    point (initially `dist` units along the view axis), tracked as
    (target, distance, azimuth, elevation) against the world axis most
    aligned with the camera's initial up — so scenes authored y-up or
    z-up both orbit naturally.  `to_transform()` re-emits a Mitsuba
    look-at (left-handed, +z = view direction, transform.cpp lookAt).
    """

    def __init__(self, to_world, dist=1.0):
        m = np.asarray(to_world.m, np.float64)
        origin = m[:3, 3].copy()
        fwd = m[:3, 2] / np.linalg.norm(m[:3, 2])
        up_hint = m[:3, 1]
        # global up = dominant world axis of the camera's own up
        axis = int(np.argmax(np.abs(up_hint)))
        self.up = np.zeros(3)
        self.up[axis] = math.copysign(1.0, up_hint[axis])
        self.dist = float(dist)
        self.target = origin + fwd * self.dist
        self._set_angles_from_forward(fwd)
        self._initial = (self.target.copy(), self.dist, self.az, self.el)

    # -- angle <-> forward (in a frame where `up` is +y) -----------------
    def _frame(self):
        u = self.up
        a = np.array([1.0, 0.0, 0.0]) if abs(u[0]) < 0.9 else np.array(
            [0.0, 0.0, 1.0]
        )
        x = np.cross(a, u)
        x /= np.linalg.norm(x)
        z = np.cross(x, u)
        return x, u, z

    def _set_angles_from_forward(self, fwd):
        x, y, z = self._frame()
        fx, fy, fz = fwd @ x, fwd @ y, fwd @ z
        self.el = math.asin(np.clip(fy, -1.0, 1.0))
        self.az = math.atan2(fx, fz)

    def _forward(self):
        x, y, z = self._frame()
        ce = math.cos(self.el)
        return (
            x * (ce * math.sin(self.az))
            + y * math.sin(self.el)
            + z * (ce * math.cos(self.az))
        )

    # -- the three mouse verbs -------------------------------------------
    def orbit(self, d_az, d_el):
        self.az += float(d_az)
        lim = math.radians(89.0)
        self.el = float(np.clip(self.el + float(d_el), -lim, lim))

    def dolly(self, factor):
        self.dist = float(np.clip(self.dist * float(factor), 1e-4, 1e6))

    def pan(self, dx, dy):
        """Move the target in the camera's screen plane, scaled by
        distance (glwidget.cpp pan: constant apparent speed)."""
        fwd = self._forward()
        right = np.cross(self.up, fwd)
        right /= np.linalg.norm(right)
        cam_up = np.cross(fwd, right)
        self.target = (
            self.target
            + (right * float(dx) + cam_up * float(dy)) * self.dist
        )

    def reset(self):
        self.target, self.dist, self.az, self.el = (
            self._initial[0].copy(),
        ) + self._initial[1:]

    def to_transform(self):
        from mitsuba_tpu_torch.core.transform import Transform

        fwd = self._forward()
        origin = self.target - fwd * self.dist
        return Transform.look_at(origin, self.target, self.up)

    def apply(self, scene, pack=None):
        """Write the rig pose into the scene sensor (and the pack's
        camera-derived array, so no re-pack is needed)."""
        tw = self.to_transform()
        scene.sensor.record.to_world = tw
        if pack is not None and "cam_w2c" in pack.arrays:
            old = pack.arrays["cam_w2c"]
            pack.arrays["cam_w2c"] = torch.as_tensor(np.asarray(tw.inv, np.float32),
                                                     device=old.device)
        return tw


def progressive_render(scene_path, spp_chunk=4, max_spp=0, on_pass=None,
                       defaults=None, camera=None, film_res=None, device="cuda"):
    """Yield (accumulated_img, total_spp, pass_seconds) after each
    pass, on `device` (the card unless the caller asks for another).
    max_spp = 0 renders forever (caller breaks).

    camera: optional dict {"rig": CameraRig|None, "version": int}.
    When `version` changes between passes the rig pose is applied and
    the accumulation restarts (total_spp drops back to one chunk) —
    the preview.h progressive-restart contract.  If "rig" is None a
    CameraRig is constructed from the scene and stored back, so the
    caller can drive it.
    """
    from mitsuba_tpu_torch.renderer import render
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from mitsuba_tpu_torch.scene.xml_loader import load_scene

    device = torch.device(device)
    scene = load_scene(scene_path, defaults=defaults)
    if film_res is not None:
        scene.sensor.record.film.width = int(film_res)
        scene.sensor.record.film.height = int(film_res)
    pack = pack_scene(scene, device)
    if camera is not None and camera.get("rig") is None:
        camera["rig"] = CameraRig(
            scene.sensor.record.to_world,
            dist=float(camera.get("dist", 1.0)),
        )
    seen_version = camera.get("version", 0) if camera else 0
    acc = None
    total = 0
    seed = 0
    while max_spp <= 0 or total < max_spp:
        if camera is not None and camera.get("version", 0) != seen_version:
            seen_version = camera["version"]
            camera["rig"].apply(scene, pack)
            acc, total = None, 0  # restart accumulation
        t0 = time.time()
        img = render(scene, spp=spp_chunk, seed=seed, device=device, pack=pack)
        dt = time.time() - t0
        acc = (
            img
            if acc is None
            else (acc * total + img * spp_chunk) / (total + spp_chunk)
        )
        total += spp_chunk
        seed += 1
        if on_pass is not None:
            on_pass(acc, total, dt)
        yield acc, total, dt


_PAGE = """<!doctype html><html><head><title>mitsuba_tpu_torch preview</title>
<style>body{background:#111;color:#ccc;font-family:monospace;
text-align:center;user-select:none}img{image-rendering:pixelated;
max-width:95vw;max-height:85vh;cursor:grab;touch-action:none}
#hud{color:#8c8}</style></head><body>
<h3 id="hud">connecting…</h3>
<img id="view" src="/img" draggable="false">
<div>left-drag orbit · wheel dolly · shift/right-drag pan · r reset</div>
<script>
const img = document.getElementById('view');
const hud = document.getElementById('hud');
let pend = {daz:0, del:0, logd:0, px:0, py:0, reset:0}, timer = null;
function queue(d) {
  for (const k in d) pend[k] += d[k];
  if (!timer) timer = setTimeout(send, 80);
}
function send() {
  timer = null;
  const q = new URLSearchParams(pend).toString();
  pend = {daz:0, del:0, logd:0, px:0, py:0, reset:0};
  fetch('/cam?' + q);
}
let drag = null;
img.addEventListener('pointerdown', e => {
  drag = {x:e.clientX, y:e.clientY, pan:e.shiftKey || e.button === 2};
  img.setPointerCapture(e.pointerId); e.preventDefault();
});
img.addEventListener('pointermove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) queue({px:-dx*0.002, py:dy*0.002});
  else queue({daz:-dx*0.005, del:-dy*0.005});
});
img.addEventListener('pointerup', () => drag = null);
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('wheel', e => {
  queue({logd: e.deltaY*0.001}); e.preventDefault();
}, {passive:false});
window.addEventListener('keydown', e => {
  if (e.key === 'r') queue({reset:1});
});
setInterval(() => {
  const next = new Image();
  next.onload = () => { img.src = next.src; };
  next.src = '/img?t=' + Date.now();
  fetch('/state').then(r => r.json()).then(s => {
    hud.textContent = `${s.scene} — ${s.spp} spp (${s.dt.toFixed(2)}s/pass)`;
  }).catch(() => {});
}, 1000);
</script></body></html>"""


def _serve(state, port):
    """state: dict with png/spp/dt/scene plus "camera" =
    {"rig": CameraRig, "version": int} shared with the render loop."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _ok(self, ctype, body):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/img":
                png = state.get("png")
                if png is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self._ok("image/png", png)
            elif url.path == "/state":
                self._ok("application/json", json.dumps({
                    "scene": state.get("scene", ""),
                    "spp": state.get("spp", 0),
                    "dt": state.get("dt", 0.0),
                }).encode())
            elif url.path == "/cam":
                q = {k: float(v[0]) for k, v in
                     parse_qs(url.query).items()}
                cam = state.get("camera")
                rig = cam.get("rig") if cam else None
                if rig is not None:
                    if q.get("reset"):
                        rig.reset()
                    if q.get("daz") or q.get("del"):
                        rig.orbit(q.get("daz", 0.0), q.get("del", 0.0))
                    if q.get("logd"):
                        rig.dolly(math.exp(q["logd"]))
                    if q.get("px") or q.get("py"):
                        rig.pan(q.get("px", 0.0), q.get("py", 0.0))
                    cam["version"] = cam.get("version", 0) + 1
                self._ok("text/plain", b"ok")
            else:
                self._ok("text/html", _PAGE.encode())

    httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mitsuba_tpu_torch.preview",
        description="progressive render preview over HTTP with an "
                    "interactive orbit camera",
    )
    p.add_argument("scene")
    p.add_argument("--port", type=int, default=8731)
    p.add_argument("--spp-chunk", type=int, default=4)
    p.add_argument("--max-spp", type=int, default=0)
    p.add_argument("--orbit-dist", type=float, default=1.0,
                   help="initial distance of the orbit target along "
                        "the view axis")
    p.add_argument("-D", action="append", default=[], metavar="k=v",
                   help="scene parameter substitution")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU instead of the card")
    args = p.parse_args(argv)
    defaults = dict(kv.split("=", 1) for kv in args.D)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("preview: no CUDA device; pass --cpu to render on the CPU")

    from mitsuba_tpu_torch.io.images import write_image

    out_png = os.path.splitext(args.scene)[0] + ".preview.png"
    camera = {"rig": None, "version": 0, "dist": args.orbit_dist}
    state = {"scene": os.path.basename(args.scene), "camera": camera}
    _serve(state, args.port)
    print(f"preview at http://localhost:{args.port}  (ctrl-c stops)")

    try:
        for acc, total, dt in progressive_render(
            args.scene, args.spp_chunk, args.max_spp,
            defaults=defaults, camera=camera, device=device,
        ):
            tone = _tonemap(acc)
            write_image(out_png, tone)
            with open(out_png, "rb") as f:
                state["png"] = f.read()
            state["spp"] = total
            state["dt"] = dt
            print(f"\r{total} spp ({dt:.2f}s/pass)", end="", flush=True)
    except KeyboardInterrupt:
        pass
    print(f"\nsaved {out_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
