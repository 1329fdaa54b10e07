"""How far one latent's render moves between batch 1 and row 0 of a batch of 2,
in the JAX package and in the port, on the same weights.

    python3 tools/bf16_batch_gap.py --preset full

The JAX G is drawn by `init(PRNGKey(0))` and its parameters are bridged into
the port's G through io/from_jax; z is `np.random.RandomState(0).randn(2,
z_dim)`. Row 0 is rendered alone and inside the batch of both rows, at the
frontal camera, in bf16 and, as the control, in fp32 (TF32 off): by JAX on
the CPU, by the port on the CPU and, where there is a card, on the card too.
Each image becomes uint8 levels (round((x + 1) * 127.5), clipped); one JSON line per
package, device and dtype gives the largest level gap, its 99th percentile, the count
of values more than 8 levels apart and the largest raw gap. Presets: `full`
(the flagship GeneratorConfig()) and `small` (the port's `random:<s>:small`
preset). Run it from the repo root.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gap_stats(a: np.ndarray, b: np.ndarray) -> dict:
    """Level statistics of two [H, W, 3] images in [-1, 1]."""
    def u8(x):
        return np.clip(np.rint((np.asarray(x, np.float64) + 1.0) * 127.5), 0, 255)

    d = np.abs(u8(a) - u8(b))
    return {"max_levels": int(d.max()), "p99_levels": float(np.percentile(d, 99)),
            "above_8_levels": int((d > 8).sum()), "values": int(d.size),
            "max_raw": float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=["full", "small"], default="full")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp
    import torch

    from ide3d_tpu import render
    from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
    from ide3d_tpu.models import Ide3dGenerator as JGenerator
    from ide3d_tpu.render.renderer import RenderParams as JRenderParams
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.io.from_jax import load_jax_params
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    rows = []
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(PRESETS[args.preset], dtype=dtype)
        z = np.random.RandomState(0).randn(2, cfg.z_dim).astype(np.float32)
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "render"}
        jG = JGenerator(JGeneratorConfig(**fields, render=JRenderParams(
            **{f.name: getattr(cfg.render, f.name) for f in dataclasses.fields(cfg.render)})))
        params = jax.jit(jG.init)(jax.random.PRNGKey(0))
        jc = jnp.broadcast_to(jnp.asarray(render.CANONICAL_POSE_25), (2, 25))
        ws = jG.mapping(params["mapping"], jnp.asarray(z), jc)
        syn = jax.jit(lambda p, w, c: jG.synthesis(p, w, c))
        pairs = {("jax", "cpu"): [np.asarray(syn(params["synthesis"], w, c)[0], np.float32)
                                  for w, c in ((ws[:1], jc[:1]), (ws, jc))]}

        G = load_jax_params(Ide3dGenerator(cfg), jax.tree_util.tree_map(np.asarray, params)).eval()
        del params, syn
        for dev in devices:
            G = G.to(dev)
            c = torch.as_tensor(CANONICAL_POSE_25, device=dev)[None].expand(2, -1)
            with torch.inference_mode():
                tws = G.mapping(torch.as_tensor(z, device=dev), c)
                pairs["torch", dev] = [G.synthesis(w, cc)[0].float().cpu().numpy()
                                       for w, cc in ((tws[:1], c[:1]), (tws, c))]
        del G
        for (package, dev), (one, two) in pairs.items():
            rows.append({"package": package, "device": dev, "preset": args.preset, "dtype": dtype,
                         "weights": "jax init(PRNGKey(0))", **gap_stats(one, two)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
