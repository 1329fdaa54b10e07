"""Average power spectrum of generated or real images (the port's avg_spectra).

Usage:
    python -m ide3d_tpu_torch.apps.avg_spectra --network random:0 --num 16 --out spectra.npz
    python -m ide3d_tpu_torch.apps.avg_spectra --data imgs/ --num 16 --out spectra_real.npz

Same CLI as `python -m ide3d_tpu.apps.avg_spectra`, plus `--device` (the CUDA
card unless asked otherwise): the Hann-windowed 2D power spectrum of the
channel mean, averaged over images, and its azimuthal average (the StyleGAN3
aliasing diagnostic). Generated images are G(z, c) at the canonical pose,
z from RandomState(i); real ones come from the port's ImageFolderDataset.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..render.camera import CANONICAL_POSE_25


def power_spectrum(images: np.ndarray) -> np.ndarray:
    """[N, H, W, C] -> mean 2D power spectrum [H, W] of the channel mean,
    Hann-windowed, zero frequency at the centre."""
    x = images.mean(axis=-1)
    n, h, w = x.shape
    win = np.hanning(h)[:, None] * np.hanning(w)[None, :]
    f = np.fft.fftshift(np.fft.fft2(x * win[None]), axes=(1, 2))
    return (np.abs(f) ** 2).mean(axis=0)


def azimuthal_average(spec: np.ndarray) -> np.ndarray:
    h, w = spec.shape
    y, x = np.indices((h, w))
    r = np.hypot(x - w / 2, y - h / 2).astype(np.int64)
    tbin = np.bincount(r.ravel(), spec.ravel())
    nr = np.bincount(r.ravel())
    return tbin / np.maximum(nr, 1)


def generated_images(G, num: int, device: torch.device | str = "cuda") -> np.ndarray:
    """G(z_i, canonical pose) for i < num, z_i from RandomState(i): [num, R, R, 3] in [-1, 1]."""
    c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
    imgs = []
    with torch.inference_mode():
        for i in range(num):
            z = torch.as_tensor(np.random.RandomState(i).randn(1, G.z_dim), dtype=torch.float32,
                                device=device)
            imgs.append(G(z, c)[0].cpu().numpy())
    return np.stack(imgs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default=None, help="random:<seed>[:preset] or a snapshot dir")
    ap.add_argument("--data", default=None)
    ap.add_argument("--num", type=int, default=16)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.network:
        from .common import load_generator

        dev = torch.device(args.device)
        imgs = generated_images(load_generator(args.network, dev), args.num, dev)
    elif args.data:
        from ..data.dataset import ImageFolderDataset

        ds = ImageFolderDataset(args.data)
        imgs = np.stack([ds.raw_item(i)[0].astype(np.float32) / 127.5 - 1.0
                         for i in range(min(args.num, len(ds)))])
    else:
        raise SystemExit("avg_spectra: give --network or --data")

    spec = power_spectrum(imgs)
    radial = azimuthal_average(spec)
    np.savez(args.out, spectrum=spec, radial=radial)
    print(f"wrote {args.out}: spectrum {spec.shape}, radial {radial.shape}")


if __name__ == "__main__":
    main()
