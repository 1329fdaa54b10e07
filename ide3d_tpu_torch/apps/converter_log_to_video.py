"""Replay a recorded Painter session into a video (counterpart of
ide3d_tpu/apps/converter_log_to_video.py; the reference's
Painter/converter_log_to_video.py): the log that `PainterSession.save_log`
writes (masks and camera angles) replayed edit by edit from the seed's
latent, each frame [rgb | seg colours].

    python -m ide3d_tpu_torch.apps.converter_log_to_video --network random:0 \\
        --encoder random:0 --log session.npz --seed 3 --output session.mp4 [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", default="random:0")
    ap.add_argument("--log", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .common import load_generator, write_video
    from .infer_hybrid_encoder import build_encoder
    from .painter import PainterSession

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    sess = PainterSession(G=G, E=build_encoder(G, args.encoder, device), device=device)
    sess.set_seed(args.seed)

    frames = [np.concatenate([rgb, seg], axis=1) for rgb, seg in sess.replay_log(args.log)]

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    out_path = write_video(args.output, frames, fps=args.fps)
    print(f"wrote {out_path} ({len(frames)} frames)")
    return out_path


if __name__ == "__main__":
    main()
