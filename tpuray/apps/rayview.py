"""Interactive viewer — the ``rayinteractive`` equivalent
(rayinteractive.c:106-208).

The reference opens a minifb window and re-renders every frame, mutating
camera state from keyboard callbacks (WASD move along dir/right, arrows =
spherical rotation at 0.05 rad, Space/Shift = up/down at 0.1;
rayinteractive.c:32-104).  The capability that matters (SURVEY.md §3.2) is
**param-swap re-render without recompile**: the jitted renderer is compiled
once and re-invoked with new camera values each frame.

Three modes:
* ``--keys`` — feed a key script (e.g. "wwassdd<space>^") and write one PNG
  per frame; the exact key->state mapping of rayinteractive.c.
* ``--serve PORT`` — the live display surface: an in-browser viewer
  streaming MJPEG frames over HTTP (works through an SSH tunnel to a
  remote GPU host, where the reference's local minifb window
  (rayinteractive.c:118-122, 183-197) cannot), with browser keyboard
  events driving the same CameraController.  The render loop re-renders
  only when camera state changes — the vsync-paced mfb_wait_sync analog.
* interactive stdin — type keys + enter; 'q' quits.

The scene defaults to the canonical render.map scene and the textures and
skybox are generated from ``--seed``; ``--scene`` renders an archive.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..camera import Camera, perspective_basis
from ..config import RenderConfig
from ..io import write_png
from ..kernels.trace import quantize_image
from ..render import choose_engine, render_from_basis
from ..scene import canonical_scene_spec
from ..sceneio import load_scene
from ..textures import seeded_assets
from ..utils.compile_cache import enable_compile_cache

MOVE_SPEED = 0.1    # rayinteractive.c:29
ROT_SPEED = 0.05    # rayinteractive.c:30


class CameraController:
    """Spherical-angle + WASD camera state machine (rayinteractive.c:32-104).

    State: origin + (x_rot, y_rot) spherical angles, y-up
    (dir = (sin x cos y, cos x, sin x sin y), rayinteractive.c:85-92).
    """

    def __init__(self, origin=(0.8, 2.5, -8.0), x_rot=np.pi / 2.0,
                 y_rot=np.pi / 2.0):
        self.origin = np.asarray(origin, np.float64)
        self.x_rot = float(x_rot)   # polar, rayinteractive.c:16
        self.y_rot = float(y_rot)   # azimuth
    @property
    def lookdir(self):
        sx, cx = np.sin(self.x_rot), np.cos(self.x_rot)
        sy, cy = np.sin(self.y_rot), np.cos(self.y_rot)
        return np.array([sx * cy, cx, sx * sy])

    def key(self, k: str) -> None:
        d = self.lookdir
        forward = -d
        right = np.cross([0.0, 1.0, 0.0], forward)  # cpu_ray.c:82-87
        up = np.cross(forward, right)               # cpu_ray.c:88-91
        if k == "w":
            self.origin += d * MOVE_SPEED
        elif k == "s":
            self.origin -= d * MOVE_SPEED
        elif k == "a":                            # rayinteractive.c:60-63
            self.origin -= right * MOVE_SPEED
        elif k == "d":                            # rayinteractive.c:65-68
            self.origin += right * MOVE_SPEED
        elif k == " ":                            # along the perspective up
            self.origin += up * MOVE_SPEED        # vector, rayinteractive.c:70-73
        elif k == "_":                            # shift = down, :75-78
            self.origin -= up * MOVE_SPEED
        elif k == "8":                            # up arrow
            self.x_rot -= ROT_SPEED
        elif k == "2":                            # down arrow
            self.x_rot += ROT_SPEED
        elif k == "4":                            # left arrow
            self.y_rot -= ROT_SPEED
        elif k == "6":                            # right arrow
            self.y_rot += ROT_SPEED

    def camera(self) -> Camera:
        return Camera(tuple(self.origin), tuple(self.lookdir), 90.0, 1.0)


_VIEWER_HTML = """<!doctype html>
<html><head><title>tpuray rayview</title><style>
  body { margin:0; background:#111; color:#ccc;
         font:13px system-ui, sans-serif; }
  #hud { padding:6px 10px; } img { display:block; margin:0 auto; }
</style></head><body>
<div id="hud">tpuray — WASD move &middot; arrows rotate &middot;
space/shift up/down &middot; <span id="stat"></span></div>
<img id="view" src="/stream">
<script>
const MAP = {"w":"w","a":"a","s":"s","d":"d"," ":" ",
             "ArrowUp":"8","ArrowDown":"2","ArrowLeft":"4",
             "ArrowRight":"6","Shift":"_"};
document.addEventListener("keydown", (e) => {
  const k = MAP[e.key];
  if (k === undefined) return;
  e.preventDefault();
  fetch("/key?k=" + encodeURIComponent(k)).then(r => r.text())
    .then(t => { document.getElementById("stat").textContent = t; });
});
</script></body></html>
"""


def serve(ctl, frame_u8, width, height, port, host="0.0.0.0",
          quality=85, started=None):
    """MJPEG live viewer (the reference's display surface, re-homed to a
    browser so it works across a tunnel to a remote GPU host).  JPEG
    encoding needs Pillow, which only this mode imports.

    ``frame_u8()`` -> HWC u8 frame for the CURRENT ctl state; it is called
    from a single render thread (JAX dispatch stays single-threaded), only
    when a key changed the camera (mfb_wait_sync analog: idle costs no
    device time).  HTTP handlers only ever read the latest encoded JPEG.
    """
    import io as _io
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("rayview --serve encodes JPEG frames with Pillow "
                         "(package 'pillow'), which is not installed; "
                         "--keys and the stdin mode need no Pillow") from e

    state = {"jpeg": b"", "seq": 0, "ms": 0.0}
    cond = threading.Condition()
    dirty = threading.Event()
    dirty.set()     # render the first frame immediately
    stop = threading.Event()

    def encode(img):
        buf = _io.BytesIO()
        Image.fromarray(img, "RGB").save(buf, "JPEG", quality=quality)
        return buf.getvalue()

    def render_loop():
        while not stop.is_set():
            if not dirty.wait(timeout=0.25):
                continue
            dirty.clear()
            t0 = time.perf_counter()
            img = frame_u8()
            jpeg = encode(img)
            with cond:
                state["jpeg"] = jpeg
                state["seq"] += 1
                state["ms"] = (time.perf_counter() - t0) * 1e3
                cond.notify_all()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                body = _VIEWER_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/key"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                for k in q.get("k", [""])[0]:
                    ctl.key(k)
                dirty.set()
                msg = (f"{state['ms']:.0f} ms/frame  origin="
                       f"{np.round(ctl.origin, 2)}").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                try:
                    while not stop.is_set():
                        with cond:
                            if state["seq"] == seen:
                                cond.wait(timeout=1.0)
                            if state["seq"] == seen:
                                continue
                            jpeg, seen = state["jpeg"], state["seq"]
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpeg)}\r\n\r\n"
                            .encode() + jpeg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif self.path.startswith("/frame.jpg"):
                with cond:
                    if state["seq"] == 0:
                        cond.wait(timeout=30.0)
                    jpeg = state["jpeg"]
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(jpeg)))
                self.end_headers()
                self.wfile.write(jpeg)
            else:
                self.send_response(404)
                self.end_headers()

    httpd = ThreadingHTTPServer((host, port), Handler)
    rt = threading.Thread(target=render_loop, daemon=True)
    rt.start()
    if started is not None:
        started(httpd, stop)
    print(f"serving on http://{host}:{httpd.server_address[1]}/ "
          "(open in a browser; WASD/arrows drive the camera)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        httpd.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=None,
                    help="scene archive (default: the canonical render.map "
                         "scene, built in)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated textures and skybox")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--keys", default=None,
                    help="scripted keypresses, one frame per key "
                         "(wasd, space, _=down, 8/2/4/6=arrows)")
    ap.add_argument("--frames-dir", default="out/frames")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live in-browser MJPEG viewer on PORT "
                         "(the display-surface mode; 0 = ephemeral port)")
    ap.add_argument("--jpeg-quality", type=int, default=85)
    args = ap.parse_args(argv)
    enable_compile_cache()

    scene = (load_scene(args.scene) if args.scene
             else canonical_scene_spec()).to_scene()
    assets = seeded_assets(args.seed)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0)
    ctl = CameraController()
    print(f"engine: {choose_engine(scene, cfg)}")

    def frame():
        basis = perspective_basis(ctl.camera(), cfg.width, cfg.height)
        t0 = time.perf_counter()
        rgb = render_from_basis(scene, assets, basis, cfg)
        img = np.asarray(quantize_image(rgb.reshape(-1, 3), cfg.width,
                                        cfg.height))
        return img, time.perf_counter() - t0

    img, dt = frame()   # compile pass
    print(f"compiled; first frame {dt:.1f}s")

    if args.serve is not None:
        serve(ctl, lambda: frame()[0], cfg.width, cfg.height, args.serve,
              quality=args.jpeg_quality)
        return

    if args.keys is not None:
        os.makedirs(args.frames_dir, exist_ok=True)
        times = []
        for i, k in enumerate(args.keys):
            ctl.key(k)
            img, dt = frame()
            times.append(dt)
            write_png(os.path.join(args.frames_dir, f"frame_{i:04d}.png"),
                      img)
        avg = sum(times) / max(len(times), 1)
        print(f"{len(times)} frames, avg {avg * 1e3:.1f} ms/frame "
              f"({1.0 / avg:.1f} fps), wrote {args.frames_dir}/")
        return

    print("keys: wasd move, space/_ up/down, 8/2/4/6 rotate, q quit")
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if line.strip() == "q":
            break
        for k in line:
            ctl.key(k)
        img, dt = frame()
        write_png("out/view.png", img)
        print(f"{dt * 1e3:.1f} ms -> out/view.png  origin={ctl.origin}")


if __name__ == "__main__":
    main()
