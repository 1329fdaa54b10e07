"""Multi-card rendering: split a frame's RAYS (one frame's latency) or a
video chunk's FRAMES (offline throughput) over a data-parallel group.

Counterpart of ide3d_tpu/parallel/render.py (shard_map over the mesh):
  * `make_ray_sharded_frame`: every rank makes the plane table (and the hybrid
    G's feature volume) itself, renders its contiguous block of
    img_size²/world rays through the coarse and fine passes (K1 on its
    block), all-gathers the composited feature and seg rows (the frame's one
    collective, [B, img_size², 51] fp32) and runs the raw head, the superres
    and the seg upsample on every rank. Per-ray work is independent, so the
    rows are those of the whole render;
  * `make_frame_sharded_chunks`: the K frames of a chunk are split over the
    ranks (K/world each, one batch through G.synthesis), post-processed on the
    rank's card and gathered in frame order.

Noise is 'const' and the render deterministic (no generator), as in the JAX
package, so every rank computes the same program on its own rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import Group, rows


def make_ray_sharded_frame(S, group: Group, render_params=None, return_seg: bool = True):
    """frame(ws [B, num_ws, w_dim], c [B, 25]) -> img | (img, seg), NHWC fp32,
    the same on every rank, with the frame's rays split over `group`. S is
    `G.synthesis`. The whole batch is rendered on every rank: this scales one
    frame's latency, not the batch's throughput."""
    cfg = S.cfg
    rp = render_params or cfg.render
    if rp.img_size != cfg.render_size:
        raise ValueError(f"render size {rp.img_size} != generator render_size {cfg.render_size}")
    total = rp.img_size * rp.img_size
    block = rows(group, total)  # raises unless the world divides the rays
    fc = S.renderer.feature_channels

    @torch.inference_mode()
    def frame(ws: torch.Tensor, c: torch.Tensor):
        table, volume = S.plane_table(ws)
        cam2world = c[:, :16].reshape(-1, 4, 4).float()
        st = S.renderer.render_coarse(None, None, cam2world, rp, None, table=table, volume=volume,
                                      ray_slice=(block.start, block.stop - block.start))
        rout = S.renderer.render_fine(st, rp, flat=True)
        comp = group.all_gather(torch.cat([rout["feature"], rout["seg"]], dim=-1), dim=1)
        B, H = comp.shape[0], rp.img_size
        img, _ = S.finish(comp[..., :fc].reshape(B, H, H, fc), ws)
        if return_seg:
            return img, S._upsample_seg(comp[..., fc:].reshape(B, H, H, -1))
        return img

    return frame


def make_frame_sharded_chunks(S, post: Callable, group: Optional[Group] = None,
                              render_params=None):
    """chunk_fn(ws_k [K, num_ws, w_dim], cs_k [K, 25]) -> post's tuple of
    per-frame tensors [K, ...] (None entries pass through), gathered in frame
    order on every rank. Rank r renders frames [r*K/n, (r+1)*K/n) as one batch
    through S(..., return_all=True) and applies `post` to its output; K must
    divide by the world size. No group: one process renders the chunk."""
    group = group or Group()
    rp = render_params or S.cfg.render

    @torch.inference_mode()
    def chunk_fn(ws_k: torch.Tensor, cs_k: torch.Tensor):
        mine = rows(group, ws_k.shape[0])
        out = post(S(ws_k[mine], cs_k[mine], render_params=rp, return_all=True))
        return tuple(None if t is None else group.all_gather(t.contiguous()) for t in out)

    return chunk_fn
