"""The yardstick's counts: K1's bytes and the FLOPs of a frame, a train step's
reference and an encoder pass, from the configuration's sizes."""

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.counts import flops, k1
from gpubench.reference import generator as ref
from gpubench.tests.tiny import GENERATOR, ROOT


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as f:
        return json.load(f)


def test_k1_bytes_of_the_flagship():
    cfg = config("ide3d-ffhq512")
    assert k1.forward_bytes(cfg, 1) == 85_819_392
    assert k1.backward_bytes(cfg, 4) == 670_433_280
    assert k1.forward_bytes(cfg, 8) == 8 * 85_819_392


def counted(fn) -> dict:
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        fn()
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_frame_flops_match_the_counted_reference():
    """The formula against torch's FLOP counter over the reference frame, less
    the composite's weighted sum and the ray rotation, which it does not count."""
    for compat in (False, True):
        g = dict(config("ide3d-ffhq512")["generator"], **GENERATOR, vb_ref_compat=compat,
                 raw_head="slice" if compat else "torgb")
        arch = ref.Arch(g)
        from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
        from ide3d_tpu_torch.render.renderer import RenderParams

        with torch.device("meta"):
            G = Ide3dGenerator(GeneratorConfig(**dict(g, render=RenderParams(**dict(
                g["render"], pixel_offset=(0.0, 0.0))))))
        P = {k: torch.randn(v.shape) for k, v in G.state_dict().items()}
        ws, c = torch.randn(1, arch.num_ws, g["w_dim"]), torch.randn(1, 25)
        total = sum(counted(lambda: ref.frame(P, arch, ws, c)).values())
        rp = g["render"]
        rays, samples = rp["img_size"] ** 2, 2 * rp["num_steps"]
        not_counted = 2 * rays * samples * (g["feature_channels"] + g["seg_channels"]) + 2 * 9 * rays
        assert flops.generator_frame({"generator": g}) == total - not_counted


def test_frame_flops_depend_on_the_configuration_alone():
    a, b = config("ide3d-ffhq512"), config("ide3d-ffhq512-pkl")
    assert flops.generator_frame(a) == 169_172_189_184
    assert flops.generator_frame(b) == 229_994_151_936
    assert flops.work_flops(a, {"g_frames": 3}) == 3 * flops.generator_frame(a)


def test_encoder_flops_match_the_counted_encoder():
    from gpubench.reference.frozen.encoder import HybridEncoder

    e = dict(config("ide3d-ffhq512")["encoder"], size=32, dtype="float32")
    E = HybridEncoder(**e)
    img, seg = torch.randn(1, 32, 32, 3), torch.randn(1, 32, 32, 19)
    assert flops.encoder_pass({"encoder": e}) == sum(counted(lambda: E(img, seg)).values())
