"""Serving artifacts: the generator as saved `torch.export` programs.

Counterpart of ide3d_tpu/io/export.py. A frozen artifact runs without the
model code: `torch.export` traces the mapping and the frame once, with the
weights embedded, and `torch.export.save` writes each program. The artifact
directory holds, for each platform it was written for:

    mapping.<platform>.pt2  (z [B,z_dim], c [B,c_dim]) -> ws [B,num_ws,w_dim],
                            truncation baked in at export time
    frame.<platform>.pt2    (ws, c) -> img [B,R,R,3] [, seg [B,R,R,19]] at
                            noise_mode='const' and without a generator: the
                            gen_images / Painter render contract
    meta.json               shapes, truncation, render params, platforms

A program fixes its device when it is traced (a CPU program would run the
plain K1 on the card), so each platform gets its own pair, traced with G on
that device; `load_artifact` loads the pair of the device asked for and never
another. K1 is recorded as the operator `ide3d_tpu_torch::sort_integrate`
(ops/ray_march.py) and an SG3 G's `filtered_lrelu` as
`ide3d_tpu_torch::filtered_lrelu` (ops/filtered_lrelu.py), so loading
imports those modules, and nothing of the models.

    meta = export_generator(G, out_dir, truncation_psi=0.7)
    art = load_artifact(out_dir, device="cuda")
    img, seg = art.render(art.map_z(z, c), c)
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch
from torch import nn

FORMAT = "ide3d_tpu_torch.export/1"
PLATFORMS = ("cuda", "cpu")


class _Mapping(nn.Module):
    def __init__(self, mapping: nn.Module, truncation_psi: float):
        super().__init__()
        self.mapping = mapping
        self.truncation_psi = truncation_psi

    def forward(self, z, c):
        return self.mapping(z, c, truncation_psi=self.truncation_psi)


class _Frame(nn.Module):
    def __init__(self, synthesis: nn.Module, render_params, return_seg: bool):
        super().__init__()
        self.synthesis = synthesis
        self.render_params = render_params
        self.return_seg = return_seg

    def forward(self, ws, c):
        return self.synthesis(ws, c, render_params=self.render_params, noise_mode="const",
                              return_seg=self.return_seg)


def _drop_metadata_asserts(ep):
    """Remove the `aten._assert_tensor_metadata` nodes that `torch.export`
    puts before each dtype cast: the program's input check already fixes
    every tensor's dtype and device, and each assert is one more op call on
    the host, a few hundred a frame."""
    graph = ep.graph_module.graph
    assert_metadata = torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target is assert_metadata:
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def _program_path(out_dir: str, name: str, platform: str) -> str:
    return os.path.join(out_dir, f"{name}.{platform}.pt2")


def export_generator(
    G,
    out_dir: str,
    batch: int = 1,
    truncation_psi: float = 1.0,
    return_seg: bool = True,
    render_params=None,
    platforms: Optional[Sequence[str]] = None,
) -> dict:
    """Write a self-contained serving artifact for `G` (weights embedded), one
    program pair per platform of `platforms` ("cuda", "cpu"; default G's own
    device type). Returns the meta dict."""
    from ..render.camera import CANONICAL_POSE_25

    own = next(G.parameters()).device
    platforms = [own.type] if platforms is None else list(platforms)
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}; choose from {PLATFORMS}")
    rp = render_params or G.cfg.render
    os.makedirs(out_dir, exist_ok=True)
    for p in platforms:
        Gp = G if own.type == p else copy.deepcopy(G).to(p)
        dev = next(Gp.parameters()).device
        z = torch.zeros(batch, G.cfg.z_dim, device=dev)
        c = torch.as_tensor(CANONICAL_POSE_25, device=dev)[None].expand(batch, -1).contiguous()
        ws = torch.zeros(batch, G.num_ws, G.cfg.w_dim, device=dev)
        with torch.no_grad():
            for name, mod, args in (("mapping", _Mapping(Gp.mapping, truncation_psi), (z, c)),
                                    ("frame", _Frame(Gp.synthesis, rp, return_seg), (ws, c))):
                torch.export.save(_drop_metadata_asserts(torch.export.export(mod.eval(), args)),
                                  _program_path(out_dir, name, p))
        del Gp

    meta = {
        "format": FORMAT,
        "batch": batch,
        "z_dim": G.cfg.z_dim,
        "c_dim": G.cfg.c_dim,
        "w_dim": G.cfg.w_dim,
        "num_ws": G.num_ws,
        "img_resolution": G.cfg.img_resolution,
        "truncation_psi": truncation_psi,
        "return_seg": return_seg,
        "render": {
            "img_size": rp.img_size,
            "num_steps": rp.num_steps,
            "fine_steps": rp.fine_steps,
        },
        "platforms": platforms,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


@dataclasses.dataclass(frozen=True)
class GeneratorArtifact:
    """A loaded serving artifact. `map_z` and `render` run the saved programs
    (no model code, no tracing) without autograd."""

    meta: dict
    _mapping: object
    _frame: object

    def map_z(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._mapping(z, c)

    def render(self, ws: torch.Tensor, c: torch.Tensor):
        """(img, seg) when the artifact was written with return_seg, else img."""
        with torch.inference_mode():
            return self._frame(ws, c)


def load_artifact(out_dir: str, device: torch.device | str = "cuda") -> GeneratorArtifact:
    """The artifact's programs for `device`'s type. Raises ValueError when the
    artifact holds none for it (it never runs another platform's program)."""
    from ..ops import filtered_lrelu, ray_march  # noqa: F401 (register the operators)

    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not an {FORMAT} artifact: {out_dir}")
    platform = torch.device(device).type
    if platform not in meta["platforms"]:
        raise ValueError(f"{out_dir} has programs for {meta['platforms']}, none for {platform}")
    mapping, frame = (torch.export.load(_program_path(out_dir, name, platform)).module()
                      for name in ("mapping", "frame"))
    return GeneratorArtifact(meta=meta, _mapping=mapping, _frame=frame)
