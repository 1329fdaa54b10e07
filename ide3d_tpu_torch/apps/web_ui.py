"""Painter web UI: a single-page frontend for the semantic mask editor.

Counterpart of ide3d_tpu/apps/web_ui.py, over the port's PainterSession
(apps/painter.py). The reference ships a PyQt app (Painter/run_UI.py:54) whose
product loop is run_deep_model (run_UI.py:167-206): paint on the 19-class mask,
re-encode (mask + current render) -> latents, re-render. Served here:

  * 19-class brush/fill canvas with per-class palette, brush size, undo/redo,
  * yaw/pitch sliders: free-view re-render without editing (the plane cache),
  * seed input + truncation (style cycling),
  * "Apply edit" = the E(G(w), mask) -> w' -> G(w') loop; the latent is carried
    across edits server-side like the Qt app's self.w (run_UI.py:203).

Usage:
    python -m ide3d_tpu_torch.apps.web_ui --network random:0 --port 8512
    python -m ide3d_tpu_torch.apps.web_ui --tiny --device cpu   # 64^2, on the CPU
    # open http://localhost:8512

API (JSON; images as base64 PNG, masks as base64 raw uint8 class ids):
  GET  /api/meta                        -> classes, palette, resolution
  POST /api/seed  {seed, trunc, yaw, pitch} -> {render, seg_ids}
  GET  /api/view?yaw=&pitch=            -> {render}
  POST /api/edit  {mask, yaw, pitch}    -> {render, seg_ids}   (advances latents)
  POST /api/load_mask {png}             -> {seg_ids}
  POST /api/orbit {type: front|orbit, stride} -> {video (b64), ext, frames}
  GET  /api/session_video               -> {video (b64), ext, frames}
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
import traceback

import numpy as np

from ..utils.profiling import span
from ..utils.seg import COLOR_MAP, LABEL_LIST

HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>IDE-3D Painter</title>
<style>
 body { font-family: sans-serif; background: #181818; color: #ddd; margin: 16px; }
 #panes { display: flex; gap: 16px; align-items: flex-start; }
 canvas, img { border: 1px solid #444; image-rendering: pixelated; }
 .tools { margin: 8px 0; display: flex; gap: 8px; flex-wrap: wrap; align-items: center;}
 .swatch { width: 22px; height: 22px; display: inline-block; border: 2px solid #222;
           cursor: pointer; }
 .swatch.sel { border-color: #fff; }
 button { background: #333; color: #ddd; border: 1px solid #555; padding: 4px 10px;
          cursor: pointer; }
 input[type=range] { width: 160px; }
 #status { color: #8c8; min-height: 1.2em; }
</style></head><body>
<h3>IDE-3D Painter <small id="status"></small></h3>
<div class="tools">
 seed <input id="seed" type="number" value="0" style="width:70px">
 <button onclick="newSeed()">new identity</button>
 trunc <input id="trunc" type="range" min="0" max="1" step="0.05" value="0.7"
              onchange="newSeed()">
 yaw <input id="yaw" type="range" min="-0.6" max="0.6" step="0.02" value="0"
            oninput="view()">
 pitch <input id="pitch" type="range" min="-0.4" max="0.4" step="0.02" value="0"
              oninput="view()">
</div>
<div class="tools">
 <span id="palette"></span>
 brush <input id="brush" type="range" min="2" max="40" value="10">
 <button onclick="undo()">undo</button>
 <button onclick="redo()">redo</button>
 <label>open mask <input id="maskfile" type="file" accept="image/png"
        style="width:180px" onchange="loadMask()"></label>
 <button id="apply" onclick="applyEdit()"><b>Apply edit</b></button>
 <button onclick="capture('orbit')">orbit video</button>
 <button onclick="capture('front')">front video</button>
 <button onclick="sessionVideo()">session video</button>
 <a id="videolink" style="display:none" download>download capture</a>
</div>
<div id="panes">
 <div><div>mask (paint here)</div><canvas id="mask"></canvas></div>
 <div><div>render</div><img id="render"></div>
</div>
<script>
let R = 0, ids = null, colors = [], cls = 1, undoStack = [], redoStack = [];
const $ = (x) => document.getElementById(x);
const status = (s) => $("status").textContent = s;

async function meta() {
  const m = await (await fetch("/api/meta")).json();
  R = m.resolution; colors = m.palette;
  const cv = $("mask"); cv.width = R; cv.height = R;
  cv.style.width = cv.style.height = "512px";
  $("render").style.width = $("render").style.height = "512px";
  const pal = $("palette");
  Object.entries(m.classes).forEach(([name, id]) => {
    const s = document.createElement("span");
    s.className = "swatch" + (id === cls ? " sel" : "");
    s.title = name; s.style.background = `rgb(${colors[id]})`;
    s.onclick = () => { cls = id;
      document.querySelectorAll(".swatch").forEach(e => e.classList.remove("sel"));
      s.classList.add("sel"); };
    pal.appendChild(s);
  });
}
function drawMask() {
  const cv = $("mask"), ctx = cv.getContext("2d");
  const img = ctx.createImageData(R, R);
  for (let i = 0; i < R * R; i++) {
    const c = colors[ids[i]];
    img.data[4*i] = c[0]; img.data[4*i+1] = c[1]; img.data[4*i+2] = c[2];
    img.data[4*i+3] = 255;
  }
  ctx.putImageData(img, 0, 0);
}
function setIds(b64) {
  ids = Uint8Array.from(atob(b64), c => c.charCodeAt(0));
  undoStack = []; redoStack = [];
  drawMask();
}
async function newSeed() {
  status("rendering…");
  const r = await (await fetch("/api/seed", {method: "POST",
    body: JSON.stringify({seed: +$("seed").value, trunc: +$("trunc").value,
                          yaw: +$("yaw").value, pitch: +$("pitch").value})})).json();
  $("render").src = "data:image/png;base64," + r.render;
  setIds(r.seg_ids);
  status("");
}
async function view() {
  const r = await (await fetch(`/api/view?yaw=${$("yaw").value}&pitch=${$("pitch").value}`)).json();
  $("render").src = "data:image/png;base64," + r.render;
}
function bytesToB64(buf) {
  // chunked: .apply with >~64k args overflows the JS argument limit at R=512
  let s = "";
  for (let i = 0; i < buf.length; i += 0x8000)
    s += String.fromCharCode.apply(null, buf.subarray(i, i + 0x8000));
  return btoa(s);
}
async function applyEdit() {
  status("applying edit…");
  const b64 = bytesToB64(ids);
  const r = await (await fetch("/api/edit", {method: "POST",
    body: JSON.stringify({mask: b64, yaw: +$("yaw").value, pitch: +$("pitch").value})})).json();
  $("render").src = "data:image/png;base64," + r.render;
  status("");
}
async function loadMask() {
  const f = $("maskfile").files[0];
  if (!f) return;
  const buf = new Uint8Array(await f.arrayBuffer());
  const r = await (await fetch("/api/load_mask", {method: "POST",
    body: JSON.stringify({png: bytesToB64(buf)})})).json();
  undoStack.push(ids.slice()); redoStack = [];
  ids = Uint8Array.from(atob(r.seg_ids), c => c.charCodeAt(0));
  drawMask();
}
function showVideo(r) {
  if (!r.frames) { status("no frames yet"); return; }
  const a = $("videolink");
  a.href = `data:video/${r.ext === "gif" ? "gif" : "mp4"};base64,` + r.video;
  a.download = "capture." + r.ext;
  a.style.display = "inline";
  a.textContent = `download capture (${r.frames} frames, .${r.ext})`;
  status("");
}
async function capture(type) {
  status(`rendering ${type} trajectory…`);
  const r = await (await fetch("/api/orbit", {method: "POST",
    body: JSON.stringify({type: type, stride: 2})})).json();
  showVideo(r);
}
async function sessionVideo() {
  status("stitching session…");
  showVideo(await (await fetch("/api/session_video")).json());
}
function undo() { if (undoStack.length) { redoStack.push(ids.slice());
                  ids = undoStack.pop(); drawMask(); } }
function redo() { if (redoStack.length) { undoStack.push(ids.slice());
                  ids = redoStack.pop(); drawMask(); } }
// brush painting
let painting = false;
function paint(e) {
  const cv = $("mask"), rect = cv.getBoundingClientRect();
  const x = Math.floor((e.clientX - rect.left) * R / rect.width);
  const y = Math.floor((e.clientY - rect.top) * R / rect.height);
  const rad = +$("brush").value;
  for (let dy = -rad; dy <= rad; dy++) for (let dx = -rad; dx <= rad; dx++) {
    if (dx*dx + dy*dy > rad*rad) continue;
    const px = x + dx, py = y + dy;
    if (px >= 0 && px < R && py >= 0 && py < R) ids[py * R + px] = cls;
  }
  drawMask();
}
window.addEventListener("load", async () => {
  await meta(); await newSeed();
  const cv = $("mask");
  cv.addEventListener("mousedown", e => { painting = true;
    undoStack.push(ids.slice()); redoStack = []; paint(e); });
  cv.addEventListener("mousemove", e => { if (painting) paint(e); });
  window.addEventListener("mouseup", () => painting = false);
});
</script></body></html>
"""


# The palette as packed 0xRRGGBB keys, sorted, with the class id of each.
_PALETTE_KEYS, _PALETTE_IDS = np.unique(
    COLOR_MAP.astype(np.int32) @ np.array([1 << 16, 1 << 8, 1], np.int32), return_index=True)
_PALETTE_IDS = _PALETTE_IDS.astype(np.uint8)


@span("web.png")
def _png_b64(img_uint8: np.ndarray) -> str:
    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(img_uint8).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


class PainterWebApp:
    """HTTP app over a PainterSession. Thread-safe via one lock (the session
    carries latent state across edits, like the Qt app's self.w)."""

    # /api/edit frames kept for /api/session_video — bounded so a long-lived
    # session can't grow host memory without limit (oldest frames drop first;
    # 600 full-res 512^2 frames ≈ 470 MB, the practical stitching ceiling)
    MAX_SESSION_FRAMES = 600

    def __init__(self, session):
        self.session = session
        self._lock = threading.Lock()
        from collections import deque

        self._session_frames = deque(maxlen=self.MAX_SESSION_FRAMES)

    # ------------------------------------------------------------------ routes

    def meta(self) -> dict:
        return {
            "classes": LABEL_LIST,
            "palette": COLOR_MAP.astype(int).tolist(),
            "resolution": self.session.G.cfg.img_resolution,
        }

    def seed(self, payload: dict) -> dict:
        with self._lock:
            self.session.set_seed(
                int(payload.get("seed", 0)), float(payload.get("trunc", 0.7))
            )
            rgb, seg_color = self.session.view(
                float(payload.get("yaw", 0)), float(payload.get("pitch", 0))
            )
            ids = self._seg_ids(seg_color)
        return {"render": _png_b64(rgb), "seg_ids": base64.b64encode(ids).decode()}

    def view(self, yaw: float, pitch: float) -> dict:
        with self._lock:
            rgb, _ = self.session.view(yaw, pitch)
        return {"render": _png_b64(rgb)}

    def edit(self, payload: dict) -> dict:
        R = self.session.G.cfg.img_resolution
        mask = np.frombuffer(
            base64.b64decode(payload["mask"]), np.uint8
        ).reshape(R, R)
        with self._lock:
            rgb, seg_color = self.session.edit(
                mask, float(payload.get("yaw", 0)), float(payload.get("pitch", 0))
            )
            ids = self._seg_ids(seg_color)
            self._session_frames.append(rgb)
        return {"render": _png_b64(rgb), "seg_ids": base64.b64encode(ids).decode()}

    @staticmethod
    def _video_b64(frames, fps: int = 24) -> dict:
        import os
        import tempfile

        from .common import write_video

        with tempfile.TemporaryDirectory() as td:
            out = write_video(os.path.join(td, "cap.mp4"), list(frames), fps=fps)
            with open(out, "rb") as f:
                data = f.read()
            ext = os.path.splitext(out)[1].lstrip(".")
        return {"video": base64.b64encode(data).decode(), "ext": ext,
                "frames": len(frames)}

    def orbit(self, payload: dict) -> dict:
        """Free-view capture (the Qt app's front/orbit trajectory buttons,
        run_UI.py:244-310) rendered through the session's cached pose-only path
        and returned as a video."""
        traj_type = payload.get("type", "orbit")
        stride = int(payload.get("stride", 1))
        # snapshot the latent under the lock, render the (long) trajectory
        # OUTSIDE it so concurrent edits aren't blocked for ~120 frames; the
        # ws= path touches no session caches (painter.py render_trajectory)
        with self._lock:
            ws = self.session.w
        frames = list(self.session.render_trajectory(traj_type, stride, ws=ws))
        return self._video_b64(frames)

    def session_video(self) -> dict:
        """Stitch every frame produced by /api/edit this session — the Painter
        log -> video round trip (Painter/converter_log_to_video.py)."""
        with self._lock:
            frames = list(self._session_frames)
        if not frames:
            return {"video": "", "ext": "", "frames": 0}
        return self._video_b64(frames)

    def load_mask(self, payload: dict) -> dict:
        """'Open real mask' (run_UI.py:364-412): accepts a PNG of class ids
        (grayscale/P-mode) OR a palette-colored mask; resizes to the canvas."""
        import PIL.Image

        R = self.session.G.cfg.img_resolution
        img = PIL.Image.open(io.BytesIO(base64.b64decode(payload["png"])))
        arr = np.asarray(img)
        if arr.ndim == 3:  # palette-colored -> nearest class color
            pal = COLOR_MAP.astype(np.int32)
            d = np.abs(arr[:, :, None, :3].astype(np.int32) - pal[None, None]).sum(-1)
            arr = d.argmin(-1).astype(np.uint8)
        arr = np.asarray(
            PIL.Image.fromarray(arr.astype(np.uint8)).resize((R, R), PIL.Image.NEAREST)
        )
        arr = np.clip(arr, 0, 18).astype(np.uint8)
        return {"seg_ids": base64.b64encode(arr.reshape(-1)).decode()}

    @staticmethod
    def _seg_ids(seg_color: np.ndarray) -> np.ndarray:
        """Colorized seg [R,R,3] (palette colours only) -> flat class ids: each
        colour packed into one integer and looked up among the palette's. A
        nearest-colour search over the 19 classes costs more host time at 512^2
        than the edit's device work (chip_smoke.py times both)."""
        c = seg_color.astype(np.int32)
        key = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        pos = np.minimum(np.searchsorted(_PALETTE_KEYS, key), len(_PALETTE_KEYS) - 1)
        if not np.array_equal(_PALETTE_KEYS[pos], key):
            raise ValueError("seg colours outside the palette")
        return _PALETTE_IDS[pos].reshape(-1)

    # ----------------------------------------------------------------- plumbing

    @span("web.request")
    def handle(self, method: str, path: str, query: dict, body: bytes):
        """Route a request; returns (status, content_type, payload_bytes)."""
        if method == "GET" and path == "/":
            return 200, "text/html", HTML.encode()
        if method == "GET" and path == "/api/meta":
            return 200, "application/json", json.dumps(self.meta()).encode()
        if method == "GET" and path == "/api/view":
            out = self.view(float(query.get("yaw", 0)), float(query.get("pitch", 0)))
            return 200, "application/json", json.dumps(out).encode()
        if method == "POST" and path == "/api/seed":
            out = self.seed(json.loads(body or b"{}"))
            return 200, "application/json", json.dumps(out).encode()
        if method == "POST" and path == "/api/edit":
            out = self.edit(json.loads(body or b"{}"))
            return 200, "application/json", json.dumps(out).encode()
        if method == "POST" and path == "/api/load_mask":
            out = self.load_mask(json.loads(body or b"{}"))
            return 200, "application/json", json.dumps(out).encode()
        if method == "POST" and path == "/api/orbit":
            out = self.orbit(json.loads(body or b"{}"))
            return 200, "application/json", json.dumps(out).encode()
        if method == "GET" and path == "/api/session_video":
            out = self.session_video()
            return 200, "application/json", json.dumps(out).encode()
        return 404, "text/plain", b"not found"


def build_session(network: str = "random:0", encoder: str = None, tiny: bool = False,
                  device="cuda"):
    """A PainterSession on `device` (the CPU only when asked): G from `network`
    (`random:<seed>[:preset]` or a snapshot directory, apps.common.load_generator),
    or the 64^2 smoke-test G with `tiny`; a HybridEncoder at G's width in G's
    dtype, with the weights of the checkpoint directory `encoder` (its "E"
    state dict, or the state itself) or else from seed 1."""
    from ..models.encoder import HybridEncoder
    from ..models.generator import GeneratorConfig, Ide3dGenerator
    from ..render.renderer import RenderParams
    from .common import load_generator
    from .painter import PainterSession

    if tiny:
        G = Ide3dGenerator(GeneratorConfig(
            img_resolution=64, render_size=16, plane_resolution=32,
            channel_base=2048, channel_max=64, sr_channel_base=1024,
            sr_channel_max=32, feature_channels=8, dtype="float32",
            render=RenderParams(img_size=16, num_steps=8),
        )).init(0).to(device).eval()
    else:
        G = load_generator(network, device)

    n_geo = G.synthesis.num_ws_geo
    E = HybridEncoder(
        size=G.cfg.img_resolution, n_latents_app=G.num_ws - n_geo,
        n_latents_geo=n_geo, w_dim=G.cfg.w_dim, input_seg_dim=G.cfg.seg_channels,
        dtype=G.cfg.dtype,  # the interactive path runs E in G's dtype (bf16 on the card)
    )
    if encoder:
        from ..io.checkpoint import load_checkpoint

        state, _ = load_checkpoint(encoder)
        E.load_state_dict(state["E"] if "E" in state else state)
    else:
        E.init(1)
    return PainterSession(G=G, E=E.to(device).eval(), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="random:0")
    ap.add_argument("--encoder", default=None, help="encoder checkpoint directory (io/checkpoint)")
    ap.add_argument("--port", type=int, default=8512)
    ap.add_argument("--tiny", action="store_true",
                    help="64^2 smoke-test generator (CPU-friendly)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    app = PainterWebApp(build_session(args.network, args.encoder, args.tiny, args.device))

    class Handler(BaseHTTPRequestHandler):
        def _route(self, method):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            try:
                status, ctype, payload = app.handle(method, url.path, q, body)
            except Exception as e:  # the server keeps running; the client sees the error
                traceback.print_exc(file=sys.stderr)
                status, ctype, payload = 500, "text/plain", str(e).encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def log_message(self, *a):
            pass

    print(f"Painter web UI on http://localhost:{args.port}")
    ThreadingHTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
