"""Apply a StyleCLIP mapper edit to inverted latents (counterpart of
ide3d_tpu/apps/styleclip_edit.py; the reference's inversion/scripts/pti_styleclip.py).

For the pivot latent w (run_pti's `<name>.npz`), a LevelsMapper renders
w + strength * mapper(w) beside w with the (optionally PTI-tuned) generator,
one batch of the two a yaw (one K1 launch). The mapper is a pretrained
StyleCLIP `.pt` (read by the stub reader, nothing in it runs) or the
checkpoint directory that train_styleclip_mapper writes.

    python -m ide3d_tpu_torch.apps.styleclip_edit --network ckpt/ \\
        --latents pti_out/face.npz --mapper mappers/afro.pt --edit-name afro \\
        --outdir edits/ [--strength 0.1] [--yaws -0.4,0,0.4] [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def load_mapper(path: str, G, edit_name=None):
    """The LevelsMapper of `path` at G's width and rows: a checkpoint directory
    of train_styleclip_mapper (the groups from `edit_name` when it names one
    of STYLECLIP_EDITS, else those saved) or a StyleCLIP .pt."""
    from ..editing.latent_editor import STYLECLIP_EDITS, LevelsMapper, import_levels_mapper
    from ..io.torch_import import load_torch_file_stubbed, state_dict_of

    if not os.path.isdir(path):
        return import_levels_mapper(state_dict_of(load_torch_file_stubbed(path)), num_ws=G.num_ws)
    from ..io.checkpoint import load_checkpoint

    state, _ = load_checkpoint(path)
    saved = {k.split(".", 1)[0] for k in state}
    if edit_name in STYLECLIP_EDITS:
        _, no_c, no_m, no_f = STYLECLIP_EDITS[edit_name]
        flags = (not no_c, not no_m, not no_f)
    else:
        flags = tuple(g in saved for g in ("course", "medium", "fine"))
    mapper = LevelsMapper(G.w_dim, G.num_ws, *flags)
    own = set(mapper.state_dict())
    mapper.load_state_dict({k: v for k, v in state.items() if k in own})
    return mapper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--latents", required=True,
                    help="npz with 'ws' [1,18,512] (run_pti output) - or a .pt")
    ap.add_argument("--mapper", required=True,
                    help="mapper checkpoint: torch .pt (pretrained StyleCLIP) "
                         "or a checkpoint dir from train_styleclip_mapper")
    ap.add_argument("--edit-name", default=None,
                    help="named edit (configures which w+ groups move)")
    ap.add_argument("--strength", type=float, default=0.1)
    ap.add_argument("--yaws", default="0", help="comma list of yaw offsets")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..render.camera import look_at_pose, make_label_25
    from .common import load_generator, save_image_grid

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    if args.latents.endswith(".pt"):
        from ..io.torch_import import load_torch_file_stubbed, state_dict_of

        ws = next(iter(state_dict_of(load_torch_file_stubbed(args.latents)).values()))
    else:
        ws = torch.as_tensor(np.load(args.latents)["ws"])
    ws = ws.float().reshape(1, G.num_ws, G.w_dim).to(device)
    mapper = load_mapper(args.mapper, G, args.edit_name).to(device).eval()

    frames = []
    with torch.no_grad():
        ws_edit = mapper.edit(ws, strength=args.strength)
        both = torch.cat([ws, ws_edit])
        for yaw in [float(y) for y in args.yaws.split(",")]:
            c = make_label_25(look_at_pose(yaw + math.pi / 2, math.pi / 2, [0.0, 0.0, 0.0],
                                           radius=2.7, device=device))
            frames.append(G.synthesis(both, c.expand(2, -1)).float().cpu().numpy())
    os.makedirs(args.outdir, exist_ok=True)
    name = args.edit_name or "edit"
    frames = np.concatenate(frames)
    path = os.path.join(args.outdir, f"{name}.png")
    save_image_grid(frames, path, grid=(len(frames) // 2, 2))
    print(f"wrote {path} (rows: yaw; cols: original | edited)")
    return {"path": path, "ws_edit": ws_edit.cpu(), "frames": frames}


if __name__ == "__main__":
    main()
