"""Painter backend: the interactive semantic-mask editing loop.

Counterpart of ide3d_tpu/apps/painter.py. The reference product loop
(Painter/run_UI.py:167-206 `run_deep_model`), per brush stroke or slider move:
  1. one-hot the edited 19-class mask, scaled to {-1, 1},
  2. render the current appearance: gen_img = G.synthesis(w, cam),
  3. re-encode: rec_ws = E(gen_img, edited_seg) + w_avg,
  4. appearance lock when editing an inversion: rec_ws[:, 8:] = w_prev[:, 8:],
  5. re-render: G.synthesis(rec_ws, cam).

Every G pass is one `G.synthesis` call, so it ends in one K1 launch (the fine
composite of `render_fine`). The session keeps two caches:
  * a plane cache: the planes of the current latent, as the renderer's table,
    with the hybrid G's feature volume (`plane_table`), so that a pose-only
    view skips `generate_planes`. The JAX session turns its plane cache off for
    a hybrid G; carrying the volume keeps the cache and renders the same frame,
  * a frame cache: the last frame rendered of (w, camera). The next edit's
    first G pass would render exactly that frame, so a stroke at an unchanged
    view costs 1 x G + E instead of 2 x G + E.
Images become uint8 on the device before the host copy.

The session's public methods run under `torch.inference_mode()` themselves:
inference mode is thread-local, and the web UI calls the session from its
server's worker threads.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.encoder import HybridEncoder
from ..models.generator import Ide3dGenerator
from ..render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
from ..utils.profiling import span
from ..utils.seg import mask2color, mask2onehot


def free_view_trajectory(traj_type: str = "orbit"):
    """Painter free-view capture paths (Painter/run_UI.py:244-288), returned as
    (yaw, pitch) SLIDER OFFSETS; PainterSession.camera adds pi/2 back.

    'front': 240-frame Lissajous wobble around the frontal view;
    'orbit': 8 x 15-frame linear sweeps, yaw 0.5->0.3->0.5->0.7->0.5 (x pi),
    then pitch 0.5->0.4->0.5->0.6->0.5.
    """
    half = math.pi / 2
    traj = []
    if traj_type == "front":
        for i in range(240):
            h = math.pi * (0.5 + 0.1 * math.cos(2 * math.pi * i / (0.5 * 240)))
            v = math.pi * (0.5 - 0.05 * math.sin(2 * math.pi * i / (0.5 * 240)))
            traj.append((h - half, v - half))
    elif traj_type == "orbit":
        for a, b in ((0.5, 0.3), (0.3, 0.5), (0.5, 0.7), (0.7, 0.5)):
            for t in np.linspace(a, b, 15):
                traj.append((float(t * math.pi - half), 0.0))
        for a, b in ((0.5, 0.4), (0.4, 0.5), (0.5, 0.6), (0.6, 0.5)):
            for t in np.linspace(a, b, 15):
                traj.append((0.0, float(t * math.pi - half)))
    else:
        raise ValueError(f"unknown trajectory {traj_type!r} (want 'front' or 'orbit')")
    return traj


def make_edit_step(G: Ide3dGenerator, E: HybridEncoder, lock_appearance: bool = True):
    """Build the edit step:

    edit_step(mask_onehot_pm [1,R,R,19], w_prev [1,18,512], c [1,25])
        -> (img [1,R,R,3], seg [1,R,R,19], rec_ws [1,18,512])

    Two G passes and one E pass. `edit_step.from_render(gen_img, ...)` takes the
    first pass's image from the caller (the frame cache)."""
    n_geo = G.synthesis.num_ws_geo

    def edit_from_render(gen_img, seg_pm, w_prev, c):
        with span("painter.encode"):
            rec_ws = E(gen_img, seg_pm) + G.mapping.w_avg
        if lock_appearance:
            rec_ws = torch.cat([rec_ws[:, :n_geo], w_prev[:, n_geo:]], dim=1)
        img, seg = G.synthesis(rec_ws, c, return_seg=True)
        return img, seg, rec_ws

    def edit_step(seg_pm, w_prev, c):
        return edit_from_render(G.synthesis(w_prev, c), seg_pm, w_prev, c)

    edit_step.from_render = edit_from_render
    return edit_step


def _img_u8(img: torch.Tensor) -> np.ndarray:
    """[1,R,R,3] in [-1, 1] -> uint8 [R,R,3] on the host, converted on the device."""
    return ((img[0] + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()


@dataclasses.dataclass(eq=False)
class PainterSession:
    """Stateful session over the edit loop (the Ex class of Painter/run_UI.py:54,
    minus Qt). G and E are moved to `device`; the CPU runs it only when asked."""

    G: Ide3dGenerator
    E: HybridEncoder
    w: Optional[torch.Tensor] = None  # current latent, carried across edits
    inversion: bool = False
    record: bool = False  # session logging (Painter/converter_log_to_video.py)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.G.to(self.device)
        self.E.to(self.device)
        self._log: list = []
        self._edit_step = make_edit_step(self.G, self.E, lock_appearance=True)
        self._edit_step_free = make_edit_step(self.G, self.E, lock_appearance=False)
        self._table_w = None  # the latent whose planes `_table` holds
        self._table = None
        self._frame_cache = None  # (w object, label on the host, img on the device)

    # ------------------------------------------------------------------ latents

    @torch.inference_mode()
    def set_seed(self, seed: int, truncation_psi: float = 0.7) -> torch.Tensor:
        """Random identity (Painter 'style cycling', run_UI.py:297-303)."""
        z = torch.as_tensor(np.random.RandomState(seed).randn(1, self.G.cfg.z_dim),
                            dtype=torch.float32, device=self.device)
        c = torch.as_tensor(CANONICAL_POSE_25, device=self.device)[None]
        self.w = self.G.mapping(z, c, truncation_psi=truncation_psi)
        self.inversion = False
        return self.w

    def set_inversion(self, ws: torch.Tensor) -> None:
        """Load a target code from inversion (run_UI.py:31-46)."""
        self.w = ws.to(self.device)
        self.inversion = True

    # --------------------------------------------------------------------- loop

    def camera(self, yaw: float = 0.0, pitch: float = 0.0, device=None) -> torch.Tensor:
        """Slider angles -> 25-dim label [1, 25] (offsets around pi/2), on the
        session's device unless another is given."""
        c2w = look_at_pose(yaw + math.pi / 2, pitch + math.pi / 2, [0.0, 0.0, 0.0], radius=2.7,
                           device=self.device if device is None else device)
        return make_label_25(c2w)

    def _label(self, yaw: float, pitch: float) -> Tuple[torch.Tensor, np.ndarray]:
        """The label on the device, and a host copy made on the host, which keys
        the frame cache without waiting for the device."""
        return self.camera(yaw, pitch), self.camera(yaw, pitch, device="cpu").numpy()

    def _planes(self, ws: torch.Tensor) -> torch.Tensor:
        """The plane cache: the table (and feature volume) of `ws`, made again
        only for another latent (compared by identity)."""
        if self._table_w is not ws:
            self._table = self.G.synthesis.plane_table(ws)
            self._table_w = ws
        return self._table

    @span("painter.to_host")
    def _to_host(self, img: torch.Tensor, seg: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        return _img_u8(img), mask2color(seg)[0].to(torch.uint8).cpu().numpy()

    def _require_latent(self) -> None:
        if self.w is None:
            raise RuntimeError("call set_seed or set_inversion first")

    @torch.inference_mode()
    def view(self, yaw: float = 0.0, pitch: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Free-view render of the current latent (no edit), through the plane
        cache. Returns (rgb uint8 [R,R,3], colorized seg uint8 [R,R,3])."""
        self._require_latent()
        c, key = self._label(yaw, pitch)
        img, seg = self.G.synthesis(self.w, c, return_seg=True, table=self._planes(self.w))
        self._frame_cache = (self.w, key, img)
        return self._to_host(img, seg)

    @span("painter.edit")
    @torch.inference_mode()
    def edit(self, mask: np.ndarray, yaw: float = 0.0,
             pitch: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Apply an edited integer mask [R, R] (class ids) at the given view.

        Updates the session latent (self.w = rec_ws, run_UI.py:203) and returns
        (rgb uint8 [R,R,3], colorized seg uint8 [R,R,3])."""
        self._require_latent()
        mask = np.array(mask, dtype=np.uint8)
        seg_pm = mask2onehot(torch.from_numpy(mask).to(self.device)[None]) * 2.0 - 1.0
        c, key = self._label(yaw, pitch)
        step = self._edit_step if self.inversion else self._edit_step_free
        fc = self._frame_cache
        if fc is not None and fc[0] is self.w and np.array_equal(fc[1], key):
            # a stroke at an unchanged view: the first G pass is the frame held
            img, seg, rec_ws = step.from_render(fc[2], seg_pm, self.w, c)
        else:
            img, seg, rec_ws = step(seg_pm, self.w, c)
        if self.record:
            self._log.append({"mask": mask, "yaw": yaw, "pitch": pitch, "t": time.time()})
        self.w = rec_ws
        self._frame_cache = (rec_ws, key, img)
        return self._to_host(img, seg)

    @torch.inference_mode()
    def render_trajectory(self, traj_type: str = "orbit", stride: int = 1,
                          ws: Optional[torch.Tensor] = None):
        """Play a capture path (freeview_render, run_UI.py:306-310), yielding
        RGB uint8 frames; one plane table serves every pose.

        With an explicit `ws` no session state is read or written (no cache):
        the web UI snapshots self.w under its lock and renders the trajectory
        outside it, so that edits are not blocked meanwhile."""
        poses = free_view_trajectory(traj_type)[::max(1, stride)]
        if ws is None:
            for yaw, pitch in poses:
                yield self.view(yaw, pitch)[0]
            return
        table = self.G.synthesis.plane_table(ws)
        for yaw, pitch in poses:
            yield _img_u8(self.G.synthesis(ws, self.camera(yaw, pitch), table=table))

    # -------------------------------------------------------------- session log

    def save_log(self, path: str) -> None:
        """Persist the edit session (masks + camera angles) for replay (the
        reference's Painter session log, Painter/converter_log_to_video.py)."""
        if not self._log:
            raise RuntimeError("nothing recorded (set record=True)")
        np.savez_compressed(
            path,
            masks=np.stack([e["mask"] for e in self._log]),
            yaw=np.asarray([e["yaw"] for e in self._log]),
            pitch=np.asarray([e["pitch"] for e in self._log]),
            t=np.asarray([e["t"] for e in self._log]),
        )

    def replay_log(self, path: str):
        """Re-run a recorded session; yields (rgb, seg_color) frames."""
        data = np.load(path)
        for i in range(len(data["yaw"])):
            yield self.edit(data["masks"][i], float(data["yaw"][i]), float(data["pitch"][i]))
