"""Interactive visualizer backend: a headless render service (counterpart of
ide3d_tpu/apps/viz_renderer.py; the reference imgui visualizer's Renderer,
viz/renderer.py:125-444).

What the reference widgets control (viz/*.py): seed, style mixing (the
geometry rows from one seed, the appearance rows from another), truncation,
pose (yaw, pitch, fov), the sampling budget and the render type (image | seg
| depth | normals | raw), with a backbone cache: the planes of the current
(seed, stylemix seed and flags, psi, cutoff) are kept as the renderer's table
(without the feature volume, as in the JAX package), so a pose change runs
the renderer and the superres stack alone. Every render is one G pass (one
K1 launch) at the state's budget, 48 + 48 samples by default; seg, depth,
normals and raw are the 64² render's. Like the JAX package, the render always uses noise_mode 'const':
`VizState.noise_mode` is not read.

`capture_layers` returns every vb block's outputs, the renderer's feature,
seg and depth, the raw RGB and each superres block's outputs, read with
forward hooks during one G pass.

The HTTP server (`main`) serves the model-browser page at / and PNG frames
at /render; `VizServer.handle` routes a request without a socket.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
from ..render.renderer import RenderParams
from ..utils.seg import mask2color


@dataclasses.dataclass
class VizState:
    seed: int = 0
    stylemix_seed: Optional[int] = None
    stylemix_geometry: bool = False  # mix rows :num_ws_geo from stylemix_seed
    stylemix_appearance: bool = False  # mix rows num_ws_geo: from stylemix_seed
    truncation_psi: float = 0.7
    truncation_cutoff: int = 14
    yaw: float = 0.0
    pitch: float = 0.0
    fov: float = 18.0
    num_steps: int = 48
    render_type: str = "image"  # image | seg | depth | normals | raw
    noise_mode: str = "const"  # not read: the render is always 'const', as in the JAX package


def _u8(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] -> uint8 on the device, then to the host."""
    return ((x + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()


class VizRenderer:
    """Renders VizStates with G (on its device) through the plane cache."""

    def __init__(self, G):
        self.G = G
        self.device = G.mapping.w_avg.device
        self._plane_cache_key = None
        self._ws = None
        self._table = None

    def _params(self, st: VizState) -> RenderParams:
        return RenderParams(img_size=self.G.cfg.render_size, num_steps=st.num_steps,
                            hierarchical=True, fov=st.fov)

    def _camera(self, st: VizState) -> torch.Tensor:
        return make_label_25(look_at_pose(st.yaw + math.pi / 2, st.pitch + math.pi / 2,
                                          [0.0, 0.0, 0.0], radius=2.7, device=self.device))

    # ------------------------------------------------------------------ latents

    def _make_ws(self, st: VizState) -> torch.Tensor:
        G = self.G
        c = torch.as_tensor(CANONICAL_POSE_25, device=self.device)[None]

        def map_seed(seed):
            z = torch.as_tensor(np.random.RandomState(seed).randn(1, G.z_dim), dtype=torch.float32,
                                device=self.device)
            return G.mapping(z, c, truncation_psi=st.truncation_psi,
                             truncation_cutoff=st.truncation_cutoff)

        ws = map_seed(st.seed)
        if st.stylemix_seed is not None and (st.stylemix_geometry or st.stylemix_appearance):
            ws2 = map_seed(st.stylemix_seed)
            n_geo = G.synthesis.num_ws_geo
            geo = ws2[:, :n_geo] if st.stylemix_geometry else ws[:, :n_geo]
            app = ws2[:, n_geo:] if st.stylemix_appearance else ws[:, n_geo:]
            ws = torch.cat([geo, app], dim=1)
        return ws

    # -------------------------------------------------------------------- frame

    def _planes(self, ws: torch.Tensor) -> tuple:
        """The table of `ws` without a feature volume: the JAX viz renderer
        samples the planes alone, also for a hybrid G (ROADMAP Queue 3)."""
        S = self.G.synthesis
        img_v, seg_v = S.generate_planes(ws, "const")
        return S.renderer.build_table(img_v.to(S.dtype), seg_v.to(S.dtype)), None

    @torch.inference_mode()
    def render(self, st: VizState) -> Tuple[np.ndarray, dict]:
        """Returns (uint8 image [H, W, 3], info with render_time and plane_cached)."""
        t0 = time.perf_counter()
        cache_key = (st.seed, st.stylemix_seed, st.stylemix_geometry,
                     st.stylemix_appearance, st.truncation_psi, st.truncation_cutoff)
        cache_hit = cache_key == self._plane_cache_key
        if not cache_hit:
            self._ws = self._make_ws(st)
            self._table = self._planes(self._ws)
            self._plane_cache_key = cache_key
        out = self.G.synthesis(self._ws, self._camera(st), render_params=self._params(st),
                               return_all=True, table=self._table)

        if st.render_type == "image":
            img = _u8(out["img"][0])
        elif st.render_type == "raw":
            img = _u8(out["img_raw"][0])
        elif st.render_type == "seg":
            img = mask2color(out["seg_raw"])[0].to(torch.uint8).cpu().numpy()
        elif st.render_type == "depth":
            d = out["depth"][0, ..., 0].float().cpu().numpy()
            d = (d - d.min()) / max(d.max() - d.min(), 1e-8)
            img = np.rint(np.repeat((d * 255)[..., None], 3, -1)).clip(0, 255).astype(np.uint8)
        elif st.render_type == "normals":
            d = out["depth"][0, ..., 0].float().cpu().numpy()
            gy, gx = np.gradient(d)
            n = np.stack([-gx, -gy, np.full_like(d, 0.02)], -1)
            n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8
            mask = (out["weights_sum"][0, ..., 0] > 0.5).cpu().numpy()
            img = np.rint((n * 0.5 + 0.5) * 255 * mask[..., None]).clip(0, 255).astype(np.uint8)
        else:
            raise ValueError(st.render_type)
        return img, {"render_time": time.perf_counter() - t0, "plane_cached": cache_hit}

    # ------------------------------------------------------------- layer capture

    @torch.inference_mode()
    def capture_layers(self, st: VizState) -> dict:
        """Named intermediate activations (the reference layer widget,
        viz/renderer.py:408-444, which reads module outputs through forward
        hooks): each vb block's x / img_v / seg_v, the renderer's feature, seg
        and depth, the raw RGB and each superres block's x / img, of one
        uncached G pass. Returns {name: {"shape": (h, w, c), "mean", "std",
        "preview": uint8 [h, w, 3]}}, channels-last as the JAX package's taps;
        the preview is the first 3 channels (or the first repeated),
        min-max normalized."""
        S = self.G.synthesis
        taps, hooks = {}, []

        def tap(prefix, names):
            def hook(_module, _inputs, outputs):
                for n, t in zip(names, outputs):
                    taps[f"{prefix}.{n}"] = t.permute(0, 2, 3, 1)
            return hook

        for res in S.voxel_block_resolutions:
            hooks.append(getattr(S, f"vb{res}").register_forward_hook(
                tap(f"vb{res}", ("x", "img_v", "seg_v"))))
        for res in S.block_resolutions:
            hooks.append(getattr(S, f"b{res}").register_forward_hook(tap(f"b{res}", ("x", "img"))))
        try:
            ws = self._make_ws(st)
            out = S(ws, self._camera(st), render_params=self._params(st), return_all=True,
                    table=self._planes(ws))
        finally:
            for h in hooks:
                h.remove()
        sr = {k: taps.pop(k) for k in [k for k in taps if not k.startswith("vb")]}
        taps.update({"renderer.feature": out["feature"], "renderer.seg": out["seg_raw"],
                     "renderer.depth": out["depth"], "raw_rgb": out["img_raw"], **sr})

        caps = {}
        for name, x in taps.items():
            arr = x[0].float().cpu().numpy()
            entry = {"shape": tuple(arr.shape), "mean": float(arr.mean()), "std": float(arr.std())}
            if arr.ndim == 3:
                pre = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1], 3, -1)
                lo, hi = pre.min(), pre.max()
                pre = (pre - lo) / max(hi - lo, 1e-8)
                entry["preview"] = np.rint(pre * 255).clip(0, 255).astype(np.uint8)
            caps[name] = entry
        return caps


_BROWSER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>IDE-3D visualizer</title>
<style>body{font-family:sans-serif;background:#181818;color:#ddd;margin:16px}
img{border:1px solid #444;width:512px;height:512px}
.t{display:flex;gap:10px;flex-wrap:wrap;align-items:center;margin:8px 0}
input[type=range]{width:150px}</style></head><body>
<h3>IDE-3D model browser <small id="ms"></small></h3>
<div class="t">
 seed <input id="seed" type="number" value="0" style="width:70px" onchange="go()">
 trunc <input id="trunc" type="range" min="0" max="1" step="0.05" value="0.7" onchange="go()">
 yaw <input id="yaw" type="range" min="-0.6" max="0.6" step="0.02" value="0" oninput="go()">
 pitch <input id="pitch" type="range" min="-0.4" max="0.4" step="0.02" value="0" oninput="go()">
 type <select id="type" onchange="go()">
  <option>image</option><option>seg</option><option>depth</option>
  <option>normals</option><option>raw</option></select>
 mix-seed <input id="mix" type="number" value="" placeholder="off" style="width:70px" onchange="go()">
 <label><input id="mix_geo" type="checkbox" onchange="go()">geometry</label>
 <label><input id="mix_app" type="checkbox" onchange="go()">appearance</label>
</div>
<img id="out">
<script>
const $=x=>document.getElementById(x); let busy=false, queued=false;
async function go(){
 if(busy){queued=true;return} busy=true;
 const p=new URLSearchParams({seed:$("seed").value,yaw:$("yaw").value,
  pitch:$("pitch").value,trunc:$("trunc").value,type:$("type").value});
 if($("mix").value!==""){p.set("mix",$("mix").value);
  p.set("mix_geo",$("mix_geo").checked?1:0);p.set("mix_app",$("mix_app").checked?1:0);}
 const t0=performance.now();
 const r=await fetch("/render?"+p); const b=await r.blob();
 $("out").src=URL.createObjectURL(b);
 $("ms").textContent=(performance.now()-t0).toFixed(0)+" ms (server "+
   (parseFloat(r.headers.get("X-Render-Time"))*1000).toFixed(0)+" ms)";
 busy=false; if(queued){queued=false;go();}
}
window.addEventListener("load",go);
</script></body></html>
"""


def state_from_query(q: dict) -> VizState:
    """The /render query (single values) -> VizState."""
    return VizState(
        seed=int(q.get("seed", 0)),
        yaw=float(q.get("yaw", 0)),
        pitch=float(q.get("pitch", 0)),
        fov=float(q.get("fov", 18)),
        truncation_psi=float(q.get("trunc", 0.7)),
        render_type=q.get("type", "image"),
        stylemix_seed=int(q["mix"]) if "mix" in q else None,
        stylemix_geometry=q.get("mix_geo", "0") == "1",
        stylemix_appearance=q.get("mix_app", "0") == "1",
    )


class VizServer:
    """The routes of the render server, callable without a socket."""

    def __init__(self, renderer: VizRenderer):
        self.renderer = renderer

    def handle(self, path: str, query: dict):
        """GET `path` with `query` -> (status, content_type, payload, extra headers)."""
        if path == "/":
            return 200, "text/html", _BROWSER_HTML.encode(), {}
        if path != "/render":
            return 404, "text/plain", b"not found", {}
        import io

        import PIL.Image

        img, info = self.renderer.render(state_from_query(query))
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, "PNG")
        return 200, "image/png", buf.getvalue(), {"X-Render-Time": f"{info['render_time']:.4f}"}


def main(argv=None):
    """Render server + model-browser page: GET / for the UI,
    GET /render?seed=0&yaw=0.2&type=image for PNG frames.

        python -m ide3d_tpu_torch.apps.viz_renderer --network <snapshot> [--port 8000] [--device cuda]
    """
    import argparse
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .common import load_generator

    server = VizServer(VizRenderer(load_generator(args.network, torch.device(args.device))))

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urlparse(self.path)
            status, ctype, payload, headers = server.handle(
                url.path, {k: v[0] for k, v in parse_qs(url.query).items()})
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    print(f"render server on :{args.port}  (GET /render?seed=0&yaw=0.3&type=seg)")
    HTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
