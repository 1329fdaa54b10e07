"""Interactive editing: one client in a closed loop through `PainterWebApp.handle`.

The traffic file's parameters: after a `seed` request in set-up (truncation
`seed_trunc`, front view), the client works view by view: a yaw drawn from
[-yaw_range, yaw_range] at pitch 0, then `strokes_per_view` POST /api/edit
requests at that yaw. The first stroke at a new yaw is an uncached edit (E and
two G passes), the others hit the session's frame cache (E and one G pass).
Each stroke paints a rectangle of one class of `classes`, its side drawn from
[side_min, side_max] of the resolution, on the class ids the last response
returned (chip_smoke's `painter_masks`, drawn from the seed). The latency of a
request is the wall time of `handle`.

For the check, `compare` requests drawn from the seed are worked out again by
the plain reference (reference/generator.py for G, the frozen HybridEncoder)
from the session's latent before each, as the session computes an edit: G at
the latent, E on that render and the stroke's one-hot mask, G at E's latent.
The reference follows the session request by request from its latent, so the
seed request, which starts the chain from the seed's z alone, is checked too,
and so is the latent the session carries out of each compared request: it has
to be the reference's (E's latent, or the seed's), since the next request
starts from it.
"""

from __future__ import annotations

import base64
import io
import json
import statistics
import time
import types

import numpy as np
import torch

from .. import weights
from ..reference import generator as ref
from . import common
from .common import FRONT_POSE, look_at_label


def _decode_png(b64: str) -> np.ndarray:
    import PIL.Image

    return np.asarray(PIL.Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _ids(b64: str, R: int) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), np.uint8).reshape(R, R)


def encoder_shapes(run) -> tuple:
    from ide3d_tpu_torch.models.encoder import HybridEncoder

    with torch.device("meta"):
        E = HybridEncoder(**run.config["encoder"])
    return {k: tuple(v.shape) for k, v in E.state_dict().items()}


def setup(run):
    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.apps.web_ui import PainterWebApp
    from ide3d_tpu_torch.models.encoder import HybridEncoder

    tr = run.traffic
    G, shapes = common.build_generator(run)
    with torch.device(run.device):
        E = HybridEncoder(**run.config["encoder"])
    E = E.to(run.device)
    weights.load_seeded(E, run.config["init"], run.seed + 4)
    E.eval().requires_grad_(False)
    session = PainterSession(G=G, E=E, device=run.device)
    st = types.SimpleNamespace(
        app=PainterWebApp(session), session=session, shapes=shapes, tr=tr,
        R=G.cfg.img_resolution, rng=np.random.default_rng([run.seed, 5]),
        lat=[], session_ms=[], log=[], yaw=0.0, ids=None, trace_units=2 * tr["strokes_per_view"])
    edit = session.edit

    def timed_edit(*args, **kw):
        t0 = time.perf_counter()
        try:
            return edit(*args, **kw)
        finally:
            st.session_ms.append(1e3 * (time.perf_counter() - t0))

    session.edit = timed_edit
    seed = int(st.rng.integers(2**31))
    st.seed_request = {"seed": seed, "trunc": tr["seed_trunc"], "yaw": 0.0, "pitch": 0.0}
    status, _, body = st.app.handle("POST", "/api/seed", {}, json.dumps(st.seed_request).encode())
    if status != 200:
        raise RuntimeError(f"seed request: status {status}")
    out = json.loads(body)
    st.seed_answer = (_decode_png(out["render"]), _ids(out["seg_ids"], st.R))
    st.ids = st.seed_answer[1]
    st.w = st.seed_w = _latent(session)
    for i in range(tr["warmup_requests"]):
        unit(st, i)
    st.lat, st.session_ms, st.log = [], [], []
    common.synchronize(run.device)
    return st


def _latent(session) -> torch.Tensor:
    return session.w.detach().float().cpu()


def stroke(st) -> np.ndarray:
    """The last returned class ids with one rectangle of one class painted on them."""
    tr, R, rng = st.tr, st.R, st.rng
    cls = int(rng.choice(tr["classes"]))
    h, w = (int(rng.uniform(tr["side_min"], tr["side_max"]) * R) for _ in range(2))
    y, x = int(rng.integers(0, R - h + 1)), int(rng.integers(0, R - w + 1))
    mask = st.ids.copy()
    mask[y:y + h, x:x + w] = cls
    return mask


def unit(st, i: int) -> None:
    if i % st.tr["strokes_per_view"] == 0:
        st.yaw = float(st.rng.uniform(-st.tr["yaw_range"], st.tr["yaw_range"]))
    mask = stroke(st)
    body = json.dumps({"mask": base64.b64encode(mask.reshape(-1)).decode(),
                       "yaw": st.yaw, "pitch": 0.0}).encode()
    t0 = time.perf_counter()
    status, _, payload = st.app.handle("POST", "/api/edit", {}, body)
    st.lat.append(1e3 * (time.perf_counter() - t0))
    if status != 200:
        st.log.append(None)
        return
    out = json.loads(payload)
    st.ids = _ids(out["seg_ids"], st.R)
    w_prev, st.w = st.w, _latent(st.session)
    st.log.append({"mask": mask, "yaw": st.yaw, "w_prev": w_prev, "w": st.w, "render": out["render"],
                   "ids": st.ids, "g_passes": 2 if i % st.tr["strokes_per_view"] == 0 else 1})


def snapshot(st) -> dict:
    return {"requests": len(st.lat)}


def finish(st, run, win) -> dict:
    n = win.snapshot["requests"]
    lat = st.lat[:n]
    st.window_session_ms = st.session_ms[:n]
    st.window_lat = lat
    failed = sum(1 for r in st.log[:n] if r is None)
    return {"attempted": n, "failed": failed,
            "e2e": {"edit_p95_ms": float(np.percentile(lat, 95)) if lat else float("inf")},
            "work": {"g_frames": sum(r["g_passes"] for r in st.log[:n] if r),
                     "e_passes": n - failed, "k1_batch": 1}}


# ------------------------------------------------------------------- check


def reference_answers(run, st, cases: list, q) -> list:
    """The reference's (image uint8 [R, R, 3], class ids [R, R], latent) of
    each case: ("seed", z) or ("edit", w_prev, mask, yaw)."""
    from ..reference.frozen import conv2d_gradfix
    from ..reference.frozen.encoder import HybridEncoder

    dev = torch.device(run.device)
    P, arch = common.reference_params(run, st.shapes)
    with torch.device(run.device):
        E = HybridEncoder(**dict(run.config["encoder"], dtype="float32"))
    E = E.to(dev)
    E.load_state_dict(weights.draw_state(encoder_shapes(run), run.config["init"], run.seed + 4, dev))
    conv2d_gradfix.QUANT = None if q is ref.exact else q

    def u8(out, w):
        img = torch.round((out["img"][0] + 1) * 127.5).clamp(0, 255).to(torch.uint8)
        return (img.cpu().numpy(), out["seg"][0].argmax(-1).to(torch.uint8).cpu().numpy(),
                w.float().cpu())

    answers = []
    try:
        with ref.tf32_off(), torch.no_grad():
            for case in cases:
                if case[0] == "seed":
                    front = torch.as_tensor(FRONT_POSE, device=dev)[None]
                    w = ref.mapping(P, arch, torch.as_tensor(case[1], device=dev)[None], front)
                    w = P["mapping.w_avg"] + (w - P["mapping.w_avg"]) * st.tr["seed_trunc"]
                    c = torch.as_tensor(look_at_label(0.0, 0.0, lookat=(0.0, 0.0, 0.0)), device=dev)[None]
                    answers.append(u8(ref.frame(P, arch, w, c, q), w))
                    continue
                _, w_prev, mask, yaw = case
                c = torch.as_tensor(look_at_label(yaw, 0.0, lookat=(0.0, 0.0, 0.0)), device=dev)[None]
                w_prev = w_prev.to(dev)
                first = ref.frame(P, arch, w_prev, c, q)["img"]
                seg_pm = torch.nn.functional.one_hot(torch.as_tensor(mask, device=dev).long(),
                                                     arch.sc).float()[None] * 2.0 - 1.0
                w = E(first, seg_pm) + P["mapping.w_avg"]
                answers.append(u8(ref.frame(P, arch, w, c, q), w))
    finally:
        conv2d_gradfix.QUANT = None
    del E, P
    common.free(run.device)
    return answers


def gap_ratios(got: list, want: list, stated: list) -> dict:
    """Over (image, class ids, latent) answers: the mean |uint8 difference| of
    the images, the share of pixels of another class and the latents' mean
    relative gap, each to the fp32 reference, over the same gap of the
    reference at the configuration's stated precision (the video's ratios)."""
    def gaps(a, b):
        img = np.mean([np.abs(x[0].astype(np.int16) - y[0]).mean() for x, y in zip(a, b)])
        seg = np.mean([(x[1] != y[1]).mean() for x, y in zip(a, b)])
        w = np.mean([float((x[2] - y[2]).norm() / y[2].norm().clamp_min(1e-30)) for x, y in zip(a, b)])
        return img, seg, w

    g, s = gaps(got, want), gaps(stated, want)
    return {name: float(a / max(b, 1e-9))
            for name, a, b in zip(("img_gap_ratio", "seg_gap_ratio", "w_gap_ratio"), g, s)}


def check(st, run, win) -> dict:
    rng = np.random.default_rng([run.seed, 6])
    done = [r for r in st.log if r is not None]
    picks = sorted(rng.choice(len(done), size=min(st.tr["compare"], len(done)), replace=False))
    z = np.random.RandomState(st.seed_request["seed"]).randn(1, run.config["generator"]["z_dim"])
    cases = [("seed", torch.as_tensor(z[0], dtype=torch.float32))]
    got = [st.seed_answer + (st.seed_w,)]
    for p in picks:
        r = done[p]
        cases.append(("edit", r["w_prev"], r["mask"], r["yaw"]))
        got.append((_decode_png(r["render"]), r["ids"], r["w"]))
    del st.app, st.session
    st.log = None
    common.free(run.device)
    dtype = run.config["generator"]["dtype"]
    want = reference_answers(run, st, cases, ref.exact)
    stated = reference_answers(run, st, cases, ref.STATED[dtype])
    out = gap_ratios(got, want, stated)
    if run.control:
        lower = gap_ratios(reference_answers(run, st, cases, ref.LOWER[dtype]), want, stated)
        out.update({"control.lower." + k: v for k, v in lower.items()})
    return out


def session_medians(st) -> tuple:
    lat, ses = st.window_lat, st.window_session_ms
    if not lat or len(ses) != len(lat):
        return None, None
    return statistics.median(ses), statistics.median([a - b for a, b in zip(lat, ses)])
