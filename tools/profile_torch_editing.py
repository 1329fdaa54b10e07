"""Where the time of the port's StyleCLIP mapper step and NADA step goes, on one CUDA card.

    python3 tools/profile_torch_editing.py [--steps 6] [--out out]

GeneratorConfig() from init(seed=0), bf16, 96+96 samples, batch 2, at the
canonical pose; a random-init full-width CLIP ViT-B/32 (ClipConfig(), init(0))
and IR-SE50 (ArcFace's JAX init), fp32, as chip_smoke.py phase 11 writes them;
cuDNN at TF32 on, PyTorch's default, as the CLIs run. After a warm-up of each
loop, for --steps mapper steps (train/styleclip.make_styleclip_step, the CLIP,
ID and latent terms) and --steps NADA steps (train/nada.make_nada_step,
geometry frozen) under torch.profiler: the host ms a step, the device's busy
ms a step and share, the top kernels and operators by device time. The full
tables go to <out>/profile_editing_{mapper,nada}.txt. Needs CUDA; fails
without it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ide3d_tpu_torch.editing.latent_editor import LevelsMapper  # noqa: E402
from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50  # noqa: E402
from ide3d_tpu_torch.models.clip import CLIP, ClipConfig, make_image_embedder  # noqa: E402
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator  # noqa: E402
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25  # noqa: E402
from ide3d_tpu_torch.train import nada, styleclip  # noqa: E402
from profile_torch_inversion import profiled  # noqa: E402

BATCH = 2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_editing: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    G = Ide3dGenerator(GeneratorConfig()).init(seed=0).cuda().eval().requires_grad_(False)
    clip_model = CLIP(ClipConfig()).init(0).cuda().eval().requires_grad_(False)
    arc = ArcFaceIRSE50().init().cuda().eval().requires_grad_(False)
    tokens = torch.zeros(1, 77, dtype=torch.long, device="cuda")
    tokens[0, :3] = torch.tensor([49406, 320, 49407])
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = args.steps

    mapper = LevelsMapper(G.w_dim, G.num_ws).init(0).cuda()
    step = styleclip.make_styleclip_step(G, mapper, clip_model, tokens, styleclip.StyleClipConfig(),
                                         embed_id=arc.embed_faces)

    def mapper_steps(k):
        for _ in range(k):
            step(styleclip.sample_latents(G, BATCH, gen))

    embed = make_image_embedder(clip_model)
    tdir = torch.randn(clip_model.cfg.embed_dim, generator=gen, device="cuda")
    G_train = nada.init_nada(G)
    nstep = nada.make_nada_step(G_train, G, embed, tdir)
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None].expand(BATCH, -1)

    def nada_steps(k):
        for _ in range(k):
            nstep(torch.randn(BATCH, G.z_dim, generator=gen, device="cuda"), c, gen)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        mapper_steps(2)  # warm-up
        profiled("mapper", lambda: mapper_steps(n), n, args.out, prefix="editing")
        nada_steps(2)
        profiled("nada", lambda: nada_steps(n), n, args.out, prefix="editing")


if __name__ == "__main__":
    main()
