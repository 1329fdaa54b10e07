"""Train a StyleCLIP LevelsMapper for a text-described edit (counterpart of
ide3d_tpu/apps/train_styleclip_mapper.py; the reference's
StyleCLIP/mapper/scripts/train.py and coach): train/styleclip.py's loop over
the IDE-3D generator, eager, one mapper step = the edited render and its
backward (+ the w render without gradient for the ID loss).

Needs CLIP weights (a torch.save'd OpenAI state dict) and the BPE vocab; the
ID loss is on only with --ir-se50 (ArcFace weights):

    python -m ide3d_tpu_torch.apps.train_styleclip_mapper --network ckpt/ \\
        --clip ViT-B-32-state.pt --bpe bpe_simple_vocab_16e6.txt.gz \\
        --description "a face with purple hair" --steps 5000 --outdir mapper_out \\
        [--ir-se50 model_ir_se50.pth] [--no-fine-mapper] [--device cuda]

Writes `<outdir>/mapper` (io/checkpoint: the mapper's state dict, the
description). Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--clip", required=True, help="CLIP ViT state_dict (.pt)")
    ap.add_argument("--bpe", required=True, help="bpe_simple_vocab_16e6.txt.gz")
    ap.add_argument("--description", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--ir-se50", default=None, help="ArcFace weights for the ID loss")
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--id-lambda", type=float, default=0.1)
    ap.add_argument("--clip-lambda", type=float, default=1.0)
    ap.add_argument("--latent-l2-lambda", type=float, default=0.8)
    ap.add_argument("--no-coarse-mapper", action="store_true")
    ap.add_argument("--no-medium-mapper", action="store_true")
    ap.add_argument("--no-fine-mapper", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..editing.latent_editor import LevelsMapper
    from ..io.checkpoint import save_checkpoint
    from ..models.clip import SimpleTokenizer, load_clip
    from ..train.styleclip import StyleClipConfig, train_styleclip_mapper
    from .common import load_generator

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    clip_model = load_clip(args.clip, device=device).requires_grad_(False)
    tokenizer = SimpleTokenizer(bpe_path=args.bpe)

    embed_id = None
    if args.ir_se50 and args.id_lambda > 0:
        from ..metrics.features import load_state_dict_file
        from ..models.arcface import ArcFaceIRSE50

        arc = load_state_dict_file(ArcFaceIRSE50(), args.ir_se50).to(device).eval()
        embed_id = arc.requires_grad_(False).embed_faces
    elif args.id_lambda > 0:
        print("no --ir-se50 weights: disabling the ID loss term")
        args.id_lambda = 0.0

    cfg = StyleClipConfig(
        description=args.description, lr=args.lr, id_lambda=args.id_lambda,
        clip_lambda=args.clip_lambda, latent_l2_lambda=args.latent_l2_lambda,
        batch_size=args.batch, max_steps=args.steps,
    )
    mapper = LevelsMapper(
        w_dim=G.w_dim, num_ws=G.num_ws,
        use_coarse=not args.no_coarse_mapper,
        use_medium=not args.no_medium_mapper,
        use_fine=not args.no_fine_mapper,
    )
    mapper = train_styleclip_mapper(G, clip_model, tokenizer, cfg=cfg, mapper=mapper,
                                    embed_id=embed_id, steps=args.steps)

    path = os.path.join(args.outdir, "mapper")
    save_checkpoint(path, mapper.state_dict(), description=args.description)
    print(f"saved mapper to {path}")
    return mapper


if __name__ == "__main__":
    main()
