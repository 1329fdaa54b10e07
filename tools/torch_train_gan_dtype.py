"""The port's train_gan with the compute dtype of G, D and the ADA pipeline
replaced: a leg of a run in float32 beside the same leg in bfloat16, to tell a
bf16 drift from a fault of the training itself. The CLI has no dtype flag
(neither has the JAX package's); this sets the configs' dtype fields, as the
Python API's `dataclasses.replace(cfg, dtype=...)` does for the bf16
batch-gap reading. After the run it prints, as one JSON line, the compute
dtypes of every G and D built and of every ADA config, and exits 1 where any
differs from --dtype (or where no G, D or ADA config was built).

    python3 tools/torch_train_gan_dtype.py --dtype float32 --data imgs/ --seg segs/ \\
        --outdir runs/f32 --preset full --batch 4 --kimg 2

Every argument but --dtype goes to ide3d_tpu_torch.apps.train_gan.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def forced_dtype(dtype: str):
    """Inside, every GeneratorConfig, DiscriminatorConfig and AugmentConfig
    made (dataclasses.replace included) carries `dtype`, wherever it is
    imported from. Yields the record of what gets built: {"G": [...], "D":
    [...], "ada": [...]} of Ide3dGenerator and Discriminator modules and
    AugmentConfigs. The classes are restored on exit."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.train.augment import AugmentConfig

    built = {"G": [], "D": [], "ada": []}
    patched = ((GeneratorConfig, "dtype", None), (DiscriminatorConfig, "dtype", None),
               (AugmentConfig, "compute_dtype", "ada"), (Ide3dGenerator, None, "G"),
               (Discriminator, None, "D"))
    inits = [cls.__init__ for cls, _, _ in patched]

    def forcing(init, field, key):
        @functools.wraps(init)
        def __init__(self, *args, **kwargs):
            init(self, *args, **kwargs)
            if field:
                object.__setattr__(self, field, dtype)  # the configs are frozen
            if key:
                built[key].append(self)
        return __init__

    for (cls, field, key), init in zip(patched, inits):
        cls.__init__ = forcing(init, field, key)
    try:
        yield built
    finally:
        for (cls, _, _), init in zip(patched, inits):
            cls.__init__ = init


def compute_dtypes(built: dict) -> dict:
    """{"G": [...], "D": [...], "ada": [...]}: the sorted dtypes that the
    built modules' layers cast to (every submodule's `dtype`) and the ADA
    configs' compute_dtype."""
    import torch

    out = {k: sorted({str(m.dtype).replace("torch.", "") for mod in built[k] for m in mod.modules()
                      if isinstance(getattr(m, "dtype", None), torch.dtype)}) for k in ("G", "D")}
    out["ada"] = sorted({c.compute_dtype for c in built["ada"]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], required=True)
    args, rest = ap.parse_known_args(argv)

    from ide3d_tpu_torch.apps import train_gan

    with forced_dtype(args.dtype) as built:
        train_gan.main(rest)
    got = compute_dtypes(built)
    print(json.dumps({"compute_dtypes": got, "built": {k: len(v) for k, v in built.items()}}),
          flush=True)
    if any(v != [args.dtype] for v in got.values()):
        raise SystemExit(f"compute dtypes {got}, not {args.dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
