"""StyleGAN-NADA text-driven domain adaptation CLI (counterpart of
ide3d_tpu/apps/train_nada.py): train/nada.py's step with the CLIP embedder.

Needs CLIP weights (a torch.save'd OpenAI state dict) and the BPE vocab:

    python -m ide3d_tpu_torch.apps.train_nada --network ckpt/ \\
        --clip ViT-B-32-state.pt --bpe bpe_simple_vocab_16e6.txt.gz \\
        --source "photo" --target "sketch" --steps 300 --outdir nada_out [--device cuda]

Writes `<outdir>/nada_g`, a snapshot of the adapted G that
apps.common.load_generator reads. z and the render draws come from one
torch.Generator seeded 0 on the device. Runs on the card; `--device cpu`
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--clip", required=True, help="CLIP ViT state_dict (.pt)")
    ap.add_argument("--bpe", required=True, help="bpe_simple_vocab_16e6.txt.gz")
    ap.add_argument("--source", required=True, help="source domain text, e.g. 'photo'")
    ap.add_argument("--target", required=True, help="target domain text, e.g. 'sketch'")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--train-geometry", action="store_true",
                    help="also adapt vb blocks + renderer (default: frozen)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..io.checkpoint import save_checkpoint
    from ..models.clip import SimpleTokenizer, load_clip, make_image_embedder, text_direction
    from ..render.camera import CANONICAL_POSE_25
    from ..train.nada import NadaConfig, init_nada, make_nada_step
    from .common import load_generator

    device = torch.device(args.device)
    G = load_generator(args.network, device).requires_grad_(False)
    clip_model = load_clip(args.clip, device=device).requires_grad_(False)
    tokenizer = SimpleTokenizer(bpe_path=args.bpe)

    embed = make_image_embedder(clip_model)
    with torch.no_grad():
        tdir = text_direction(clip_model, tokenizer, args.source, args.target)

    cfg = NadaConfig(lr=args.lr, freeze_geometry=not args.train_geometry)
    G_train = init_nada(G, cfg)
    step = make_nada_step(G_train, G, embed, tdir, cfg)

    gen = torch.Generator(device=device).manual_seed(0)
    c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None].expand(args.batch, -1)
    losses = []
    for i in range(args.steps):
        z = torch.randn(args.batch, G.z_dim, generator=gen, device=device)
        losses.append(step(z, c, gen))
        if i % 10 == 0:
            print(f"step {i}: directional loss {float(losses[-1]):.4f}")

    path = os.path.join(args.outdir, "nada_g")
    save_checkpoint(path, {"G_ema": G_train.state_dict()}, config=G.cfg,
                    source=args.source, target=args.target)
    print(f"saved adapted generator to {path}")
    return {"G": G_train.requires_grad_(False), "losses": [float(v) for v in losses],
            "path": path}


if __name__ == "__main__":
    main()
