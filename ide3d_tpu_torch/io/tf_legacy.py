"""TF1-era legacy pickle conversion (the reference's legacy.py:143-327).

Counterpart of ide3d_tpu/io/tf_legacy.py, numpy and torch only. StyleGAN and
StyleGAN2 checkpoints from the TensorFlow codebases pickle as a 3-tuple
``(G, D, Gs)`` of ``dnnlib.tflib.network.Network`` objects whose state holds
``static_kwargs`` (construction args), ``variables`` (a list of ``(name,
np.ndarray)``) and nested ``components``. `io.torch_import.load_pickle_tensors`
reads them with its stub unpickler (nothing from the pickle runs; each Network
becomes a dict of its state). The per-variable name map of the reference
(`legacy.py:203-241,283-303`) gives a modern-named, torch-layout state dict:
conv weights [kh, kw, in, out] -> [out, in, kh, kw] (Conv0_up and Skip also
flipped in space: TF's upsampling conv correlates with a flipped kernel),
dense [in, out] -> [out, in], mod_bias + 1, the per-layer noise from the
shared synthesis/noise{k} list. The generator is hosted in
models/stylegan2.StyleGan2Generator, the discriminator in
models/discriminator.Discriminator through `import_discriminator`.

Scope as the reference and the JAX package: skip-architecture G (and the
progressive-era ToRGB_lod 'orig' generator), resnet-architecture D, version
>= 4 pickles; a progressive FromRGB_lod discriminator is rejected.
"""

from __future__ import annotations


import re
from typing import Dict, Tuple, Union

import numpy as np
import torch

_MISSING = object()


def _field(obj, name, default=_MISSING):
    """A tflib pickle state field. The stub unpickler keeps the state as dict
    items (io/torch_import._Stub); a live object carries it as attributes.
    Accept both."""
    if isinstance(obj, dict) and name in obj:
        return obj[name]
    val = getattr(obj, name, default)
    if val is _MISSING:
        raise KeyError(name)
    return val


def is_tf_network_stub(obj) -> bool:
    """True for a (stubbed) TF Network: carries the tflib pickle state
    version/static_kwargs/variables."""
    try:
        for k in ("version", "static_kwargs", "variables"):
            _field(obj, k)
        return True
    except (KeyError, TypeError):
        return False


def is_tf_legacy_payload(payload) -> bool:
    """The TF-legacy form: a 3-tuple (G, D, Gs) of tflib Network states
    (legacy.py:27)."""
    return (
        isinstance(payload, tuple)
        and len(payload) == 3
        and all(is_tf_network_stub(n) for n in payload)
    )


def collect_tf_params(tf_net) -> Dict[str, np.ndarray]:
    """Flatten variables of a network and its components ('mapping/...',
    'synthesis/...') — legacy.py:109-118."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in _field(net, "variables"):
            out[prefix + name] = np.asarray(value)
        for name, comp in dict(_field(net, "components", None) or {}).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


def _kwargs_reader(tf_net):
    static = dict(_field(tf_net, "static_kwargs", None) or {})
    known = set()

    def kwarg(name, default=None):
        known.add(name)
        return static.get(name, default)

    def unknown():
        return sorted(set(static) - known)

    return kwarg, unknown


def convert_tf_generator_sd(tf_G) -> Tuple[Dict[str, np.ndarray], dict]:
    """TF network state -> (modern torch-layout G state dict, config kwargs).

    Name/layout map is legacy.py:203-241: conv weights [kh,kw,in,out] ->
    [out,in,kh,kw] (Conv0_up/Skip additionally spatially flipped — TF's
    upsampling conv correlates with a flipped kernel), dense [in,out] ->
    [out,in], mod_bias stored minus the modern +1 baseline, per-layer noise
    buffers pulled from the shared synthesis/noise{k} list.
    """
    if int(_field(tf_G, "version", 0)) < 4:
        raise ValueError("TensorFlow pickle version too low")  # legacy.py:145
    kwarg, unknown = _kwargs_reader(tf_G)
    kwargs = dict(
        z_dim=int(kwarg("latent_size", 512)),
        c_dim=int(kwarg("label_size", 0)),
        w_dim=int(kwarg("dlatent_size", 512)),
        img_resolution=int(kwarg("resolution", 1024)),
        img_channels=int(kwarg("num_channels", 3)),
        channel_base=int(kwarg("fmap_base", 16384)) * 2,
        channel_max=int(kwarg("fmap_max", 512)),
        conv_clamp=kwarg("conv_clamp", None),
        mapping_num_layers=int(kwarg("mapping_layers", 8)),
        mapping_embed_features=kwarg("label_fmaps", None),
    )
    for ignored in ("w_avg_beta", "truncation_psi", "truncation_cutoff", "style_mixing_prob",
                    "structure", "conditioning", "fused_modconv", "num_fp16_res",
                    "use_noise", "nonlinearity", "mapping_nonlinearity",
                    "mapping_fmaps", "mapping_lrmul", "architecture",
                    "resample_kernel"):
        kwarg(ignored)
    if unknown():
        raise ValueError(f"Unknown TensorFlow kwarg {unknown()[0]}")
    arch = kwarg("architecture", "skip") or "skip"
    if arch not in ("skip", "orig"):
        raise NotImplementedError(
            f"unsupported TF generator architecture {arch!r}")

    p = collect_tf_params(tf_G)
    # Progressive-era checkpoints name their growing outputs ToRGB_lodN;
    # lod n renders at resolution/2^n, so lod0 is the full-resolution head.
    # Remap into the modern per-resolution name and switch to the 'orig'
    # architecture (one final ToRGB, no skips) — legacy.py:195-200 intent.
    # NOTE the reference's own branch is vestigial: it fullmatches the names
    # WITHOUT a 'synthesis/' prefix but every later lookup requires one, so
    # neither component layout can actually convert there. Both layouts are
    # handled here.
    for name in list(p):
        m = re.fullmatch(r"(?:synthesis/)?ToRGB_lod(\d+)/(.*)", name)
        if m:
            r = kwargs["img_resolution"] // (2 ** int(m.group(1)))
            p[f"synthesis/{r}x{r}/ToRGB/{m.group(2)}"] = p[name]
            arch = "orig"
    kwargs["architecture"] = arch

    sd: Dict[str, np.ndarray] = {}

    def put(dst, arr):
        a = np.asarray(arr, np.float32)
        # np.ascontiguousarray promotes 0-d to (1,); keep scalars scalar
        sd[dst] = a if a.ndim == 0 else np.ascontiguousarray(a)

    def conv_w(arr, flip=False):
        a = np.asarray(arr)
        if flip:
            a = a[::-1, ::-1]
        return a.transpose(3, 2, 0, 1)  # [kh,kw,in,out] -> [out,in,kh,kw]

    put("mapping.w_avg", p["dlatent_avg"])
    if "mapping/LabelEmbed/weight" in p:
        put("mapping.embed.weight", p["mapping/LabelEmbed/weight"].T)
        put("mapping.embed.bias", p["mapping/LabelEmbed/bias"])
    for i in range(kwargs["mapping_num_layers"]):
        put(f"mapping.fc{i}.weight", p[f"mapping/Dense{i}/weight"].T)
        put(f"mapping.fc{i}.bias", p[f"mapping/Dense{i}/bias"])

    def put_layer(dst, src, noise_idx, flip=False):
        put(f"{dst}.weight", conv_w(p[f"{src}/weight"], flip=flip))
        put(f"{dst}.bias", p[f"{src}/bias"])
        put(f"{dst}.noise_const", p[f"synthesis/noise{noise_idx}"][0, 0])
        put(f"{dst}.noise_strength", p[f"{src}/noise_strength"])
        put(f"{dst}.affine.weight", p[f"{src}/mod_weight"].T)
        put(f"{dst}.affine.bias", p[f"{src}/mod_bias"] + 1)

    def put_torgb(dst, src):
        put(f"{dst}.weight", conv_w(p[f"{src}/weight"]))
        put(f"{dst}.bias", p[f"{src}/bias"])
        put(f"{dst}.affine.weight", p[f"{src}/mod_weight"].T)
        put(f"{dst}.affine.bias", p[f"{src}/mod_bias"] + 1)

    R = kwargs["img_resolution"]
    orig = arch == "orig"
    put("synthesis.b4.const", p["synthesis/4x4/Const/const"][0])
    put_layer("synthesis.b4.conv1", "synthesis/4x4/Conv", 0)
    if not orig or R == 4:
        put_torgb("synthesis.b4.torgb", "synthesis/4x4/ToRGB")
    res = 8
    while res <= R:
        n = int(np.log2(res))
        put_layer(f"synthesis.b{res}.conv0", f"synthesis/{res}x{res}/Conv0_up",
                  2 * n - 5, flip=True)
        put_layer(f"synthesis.b{res}.conv1", f"synthesis/{res}x{res}/Conv1",
                  2 * n - 4)
        # 'orig': the module holds ONE ToRGB, on the final block; lower-lod
        # heads in the checkpoint are progressive-growing leftovers the torch
        # module likewise drops (_populate only reads module-held params)
        if not orig or res == R:
            put_torgb(f"synthesis.b{res}.torgb", f"synthesis/{res}x{res}/ToRGB")
        if f"synthesis/{res}x{res}/Skip/weight" in p:
            put(f"synthesis.b{res}.skip.weight",
                conv_w(p[f"synthesis/{res}x{res}/Skip/weight"], flip=True))
        res *= 2
    return sd, kwargs


def convert_tf_discriminator_sd(tf_D) -> Tuple[Dict[str, np.ndarray], dict]:
    """TF network state -> (modern torch-layout D state dict, config kwargs);
    name map legacy.py:283-303."""
    if int(_field(tf_D, "version", 0)) < 4:
        raise ValueError("TensorFlow pickle version too low")
    kwarg, unknown = _kwargs_reader(tf_D)
    kwargs = dict(
        c_dim=int(kwarg("label_size", 0)),
        img_resolution=int(kwarg("resolution", 1024)),
        img_channels=int(kwarg("num_channels", 3)),
        channel_base=int(kwarg("fmap_base", 16384)) * 2,
        channel_max=int(kwarg("fmap_max", 512)),
        cmap_dim=kwarg("mapping_fmaps", None),
        mapping_num_layers=int(kwarg("mapping_layers", 0)),
        mbstd_group_size=kwarg("mbstd_group_size", None),
    )
    for ignored in ("structure", "conditioning", "architecture", "nonlinearity",
                    "mbstd_num_features", "resample_kernel", "num_fp16_res",
                    "conv_clamp", "freeze_layers", "mapping_lrmul"):
        kwarg(ignored)
    if unknown():
        raise ValueError(f"Unknown TensorFlow kwarg {unknown()[0]}")

    p = collect_tf_params(tf_D)
    if any(re.fullmatch(r"(?:.*/)?FromRGB_lod(\d+)/(.*)", n) for n in p):
        # G-side ToRGB_lod checkpoints DO convert (architecture='orig',
        # convert_tf_generator_sd) — that covers rendering from Gs, the use
        # case legacy imports exist for. Hosting an 'orig' D would mean a
        # skip-less architecture variant of the production dual-branch D for
        # a D nobody fine-tunes from; the reference's own FromRGB_lod branch
        # (legacy.py:294-299) is vestigial (prefix mismatch, see the G-side
        # note), so there is no working behavior to be at parity with.
        raise NotImplementedError(
            "progressive-era FromRGB_lod DISCRIMINATORS are not hosted "
            "(the paired generator converts; see convert_tf_generator_sd)")

    sd: Dict[str, np.ndarray] = {}

    def put(dst, arr):
        a = np.asarray(arr, np.float32)
        # np.ascontiguousarray promotes 0-d to (1,); keep scalars scalar
        sd[dst] = a if a.ndim == 0 else np.ascontiguousarray(a)

    def conv_w(arr, flip=False):
        a = np.asarray(arr)
        if flip:
            a = a[::-1, ::-1]
        return a.transpose(3, 2, 0, 1)

    res = kwargs["img_resolution"]
    while res > 4:
        if f"{res}x{res}/FromRGB/weight" in p:
            put(f"b{res}.fromrgb.weight", conv_w(p[f"{res}x{res}/FromRGB/weight"]))
            put(f"b{res}.fromrgb.bias", p[f"{res}x{res}/FromRGB/bias"])
        for i, tf_name in ((0, "Conv0"), (1, "Conv1_down")):
            put(f"b{res}.conv{i}.weight", conv_w(p[f"{res}x{res}/{tf_name}/weight"]))
            put(f"b{res}.conv{i}.bias", p[f"{res}x{res}/{tf_name}/bias"])
        if f"{res}x{res}/Skip/weight" in p:
            put(f"b{res}.skip.weight", conv_w(p[f"{res}x{res}/Skip/weight"]))
        res //= 2
    if "LabelEmbed/weight" in p:
        put("mapping.embed.weight", p["LabelEmbed/weight"].T)
        put("mapping.embed.bias", p["LabelEmbed/bias"])
    for name in list(p):
        m = re.fullmatch(r"Mapping(\d+)/(weight|bias)", name)
        if m:
            arr = p[name].T if m.group(2) == "weight" else p[name]
            put(f"mapping.fc{m.group(1)}.{m.group(2)}", arr)
    put("b4.conv.weight", conv_w(p["4x4/Conv/weight"]))
    put("b4.conv.bias", p["4x4/Conv/bias"])
    put("b4.fc.weight", p["4x4/Dense0/weight"].T)
    put("b4.fc.bias", p["4x4/Dense0/bias"])
    put("b4.out.weight", p["Output/weight"].T)
    put("b4.out.bias", p["Output/bias"])
    return sd, kwargs


def import_tf_generator(tf_G, device: Union[torch.device, str] = "cuda"):
    """TF network state -> (fp32 StyleGan2Generator on `device`, ImportReport)."""
    from ..models.stylegan2 import StyleGan2Config, StyleGan2Generator
    from .torch_import import ImportReport, _Dest, _import_mapping, _map_block_tensors

    sd, kw = convert_tf_generator_sd(tf_G)
    G = StyleGan2Generator(StyleGan2Config(**kw)).init(0)
    dest = _Dest(G)
    imported: list = []
    skipped: list = []
    _import_mapping(sd, "mapping.", dest, imported, skipped)
    for res in G.block_resolutions:
        _map_block_tensors(sd, f"synthesis.b{res}.", f"synthesis.b{res}.", dest, imported, skipped)
    report = ImportReport(imported=len(imported), skipped_source=tuple(sorted(skipped)))
    return G.to(device).eval(), report


def import_tf_discriminator(tf_D, device: Union[torch.device, str] = "cuda"):
    """TF network state -> (bf16 Discriminator on `device`, ImportReport),
    through the reference-pickle importer (the converted names are its
    contract)."""
    from .torch_import import import_discriminator

    sd, _kw = convert_tf_discriminator_sd(tf_D)
    return import_discriminator(sd, dtype="bfloat16", device=device)


def convert_tf_payload(payload, device: Union[torch.device, str] = "cuda") -> dict:
    """(G, D, Gs) TF tuple -> {'G' | 'D' | 'G_ema': (module on `device`,
    ImportReport)}, the shape io.torch_import.load_network_pkl returns
    (legacy.py:27-33); an entry that fails to convert holds its exception."""
    tf_G, tf_D, tf_Gs = payload
    out = {}
    for key, net, imp in (("G", tf_G, import_tf_generator),
                          ("D", tf_D, import_tf_discriminator),
                          ("G_ema", tf_Gs, import_tf_generator)):
        try:
            out[key] = imp(net, device=device)
        except Exception as e:  # per-entry failures reported, not fatal
            out[key] = e
    return out
