"""Extract 3D density grids from the generator (the port's extract_shapes).

Usage:
    python -m ide3d_tpu_torch.apps.extract_shapes --network random:0 --seeds 0-2 \
        --voxel-resolution 256 --cube-size 0.3 --outdir shapes/

Same CLI as `python -m ide3d_tpu.apps.extract_shapes`, plus `--device` (the
CUDA card unless asked otherwise). Per seed: z -> w+, the vb plane stack once
and its sampling table once (fp32 planes), then sigma (the last of the 52
channels) over an N^3 probe cube scaled by 0.9, in chunks of `--max-batch`
points with the padded tail trimmed. Saves {seed}.npy (+ .mrc when mrcfile is
installed). `main` returns {"seconds_per_seed": [...], "outdir"}.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..render.camera import CANONICAL_POSE_25


def create_samples(N: int, cube_length: float) -> np.ndarray:
    """The probe cube's points [N^3, 3]: z index fastest, then y, then x,
    from the cube's corner."""
    voxel_origin = np.array([0.0, 0.0, 0.0]) - cube_length / 2
    voxel_size = cube_length / (N - 1)
    overall = np.arange(N**3, dtype=np.int64)
    samples = np.zeros((N**3, 3), dtype=np.float32)
    samples[:, 2] = overall % N
    samples[:, 1] = (overall // N) % N
    samples[:, 0] = (overall // (N * N)) % N
    samples[:, 0] = samples[:, 0] * voxel_size + voxel_origin[2]
    samples[:, 1] = samples[:, 1] * voxel_size + voxel_origin[1]
    samples[:, 2] = samples[:, 2] * voxel_size + voxel_origin[0]
    return samples


@torch.inference_mode()
def fp32_table(G, ws: torch.Tensor) -> torch.Tensor:
    """The renderer's sampling table of one w+'s planes, in fp32 (not the
    frame's compute dtype)."""
    img_v, seg_v = G.synthesis.generate_planes(ws)
    return G.synthesis.renderer.build_table(img_v, seg_v)


@torch.inference_mode()
def sigma_grid(renderer, table: torch.Tensor, samples: np.ndarray, max_batch: int) -> torch.Tensor:
    """sigma [len(samples)] at `samples` (world points [P, 3]) from one plane
    table, on its device, `max_batch` points at a time."""
    pad = (-len(samples)) % max_batch
    chunks = torch.as_tensor(np.pad(samples, ((0, pad), (0, 0))), device=table.device)
    sigma = torch.empty(chunks.shape[0], device=table.device)
    for i in range(0, chunks.shape[0], max_batch):
        out = renderer.sample_table(table, chunks[None, i:i + max_batch])
        sigma[i:i + max_batch] = out[0, :, -1].float()
    return sigma[:len(samples)]


def seed_ws(G, seed: int, truncation_psi: float, device: torch.device | str) -> torch.Tensor:
    """The w+ [1, num_ws, w_dim] of a seed at the canonical pose."""
    z = torch.as_tensor(np.random.RandomState(seed).randn(1, G.z_dim), dtype=torch.float32,
                        device=device)
    c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
    with torch.inference_mode():
        return G.mapping(z, c, truncation_psi=truncation_psi)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True, help="random:<seed>[:preset] or a snapshot dir")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trunc", type=float, default=1.0)
    ap.add_argument("--cube-size", type=float, default=0.3)
    ap.add_argument("--voxel-resolution", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=2**18)
    ap.add_argument("--outdir", default="shapes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .common import load_generator, parse_range

    dev = torch.device(args.device)
    G = load_generator(args.network, dev)
    os.makedirs(args.outdir, exist_ok=True)
    N = args.voxel_resolution
    samples = 0.9 * create_samples(N, args.cube_size)
    seconds = []
    for seed in parse_range(args.seeds):
        t0 = time.perf_counter()
        table = fp32_table(G, seed_ws(G, seed, args.trunc, dev))
        sig = sigma_grid(G.synthesis.renderer, table, samples, args.max_batch)
        sig = sig.cpu().numpy().reshape(N, N, N)
        seconds.append(time.perf_counter() - t0)
        np.save(os.path.join(args.outdir, f"{seed}.npy"), sig)
        try:
            import mrcfile

            with mrcfile.new_mmap(os.path.join(args.outdir, f"{seed}.mrc"), overwrite=True,
                                  shape=sig.shape, mrc_mode=2) as mrc:
                mrc.data[:] = sig
        except ImportError:
            pass
        print(f"seed {seed}: sigma grid {sig.shape}, range [{sig.min():.3f}, {sig.max():.3f}], "
              f"{seconds[-1]:.3f} s")
    return {"seconds_per_seed": seconds, "outdir": args.outdir}


if __name__ == "__main__":
    main()
