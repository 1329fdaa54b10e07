"""Reference checkpoint import: a reference .pkl -> the port's modules.

Counterpart of ide3d_tpu/io/torch_import.py, with the same report and the same
architecture inference:

  * `load_pickle_tensors(path)` reads a reference .pkl with a stub unpickler:
    every class outside a short allow-list of tensor and container
    reconstructors becomes a dict-like stub holding its pickled state, and
    tensor storages are read with `torch.load(weights_only=True)`. Nothing
    from the pickle is executed (the reference's source-embedding pickles
    carry their classes as code).
  * `pickle_payload_to_state_dicts(obj)` walks the (stubbed) module graph's
    `_parameters` / `_buffers` / `_modules` into {entry: {dotted name: array}}
    per top-level entry (G, D, G_ema, E), through the `state` of the
    reference's persistent-object records.
  * `import_generator`, `import_discriminator`, `import_encoder` infer the
    architecture from a state dict, build the port's module (reference-compat
    generator: `vb_ref_compat=True, raw_head="slice"`) and load the tensors by
    name. Each returns (module on `device`, ImportReport).
  * `load_network_pkl(path)` does all of that for every entry of a pickle; a
    TF1-era (G, D, Gs) pickle goes through io/tf_legacy.py.
  * `load_torch_state_dict(path)` reads a .pt / .pth state dict (MTCNN's
    pnet/rnet/onet.pt, Deep3DFaceRecon's epoch_20.pth) through the stub reader.
  * `load_torch_file_stubbed(path)` reads a torch.save (zip) file, such as an
    e4e checkpoint with its pickled `opts`, through the same stub unpickler;
    `import_bisenet(path)` loads `segNet-20Class.pth` (weights_only=True).

The reference state dict is already in the port's layout (OIHW convs,
[out, in] FCs, [C, H, W] consts), so tensors map straight onto the port's
`state_dict()` names. Two places keep the JAX layout and are converted here:
the discriminator epilogue's FC flattens its input in (H, W, C) order (the
reference in C, H, W), so its columns are permuted; the renderer decoder is
[in, out], so a matched 2-D weight is transposed (and rescaled by sqrt(fan_in)
when it looks like a plain nn.Linear, as the JAX importer does).

Imports numpy and torch only.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import re
import zipfile
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn


# ------------------------------------------------------------------ pkl reading


def _storage_from_bytes(b: bytes):
    """torch.storage._load_from_bytes without running the pickle it holds."""
    return torch.load(io.BytesIO(b), weights_only=True)


# What a pickle may resolve to a real object: tensor and storage
# reconstructors, numpy arrays and plain containers. Everything else is stubbed.
_ALLOWED = {
    ("torch._utils", "_rebuild_tensor_v2"), ("torch._utils", "_rebuild_tensor"),
    ("torch._utils", "_rebuild_parameter"), ("torch._utils", "_rebuild_parameter_with_state"),
    ("collections", "OrderedDict"), ("_codecs", "encode"), ("copyreg", "_reconstructor"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
}
_ALLOWED_BUILTINS = {"set", "frozenset", "object", "bytearray", "slice", "complex"}


class _Stub(dict):
    """An unknown class of the pickle: its state, as dict items."""

    _module = _name = ""

    def __init__(self, *args, **kwargs):
        super().__init__()
        if len(args) == 1 and isinstance(args[0], dict):
            self.update(args[0])
        self.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.update(state)
        elif isinstance(state, tuple) and state and isinstance(state[0], dict):
            self.update(state[0])


class _TensorStubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _storage_from_bytes
        if (module, name) in _ALLOWED or (
                module in ("builtins", "__builtin__") and name in _ALLOWED_BUILTINS):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"_module": module, "_name": name})

    def persistent_load(self, pid):
        return pid


def load_pickle_tensors(path: str):
    """The object graph of a reference .pkl, its classes stubbed (see the
    module docstring)."""
    with open(path, "rb") as f:
        return _TensorStubUnpickler(f).load()


# The storage classes a torch.save file names for its tensors' storages.
_STORAGE_DTYPES = {
    "FloatStorage": torch.float32, "DoubleStorage": torch.float64, "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16, "LongStorage": torch.int64, "IntStorage": torch.int32,
    "ShortStorage": torch.int16, "CharStorage": torch.int8, "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


def load_torch_file_stubbed(path: str):
    """The object graph of a torch.save file (the zip format) read by the stub
    unpickler: tensors come back as tensors (storages read from the zip's
    records), every class outside the allow-list as a dict-like stub of its
    pickled state (an argparse Namespace's fields as dict items). Nothing from
    the pickle is executed, unlike torch.load(weights_only=False)."""
    with zipfile.ZipFile(path) as zf:
        pkl = [n for n in zf.namelist() if n == "data.pkl" or n.endswith("/data.pkl")]
        if len(pkl) != 1:
            raise ValueError(f"{path}: not a torch.save zip file (found {len(pkl)} data.pkl)")
        root = pkl[0][: -len("data.pkl")]
        storages = {}

        class _ZipUnpickler(_TensorStubUnpickler):
            def persistent_load(self, pid):
                kind, storage_type, key, _location, _numel = pid
                name = getattr(storage_type, "_name", "")
                if kind != "storage" or name not in _STORAGE_DTYPES:
                    raise pickle.UnpicklingError(f"{path}: unsupported persistent id {pid!r}")
                if key not in storages:
                    dtype = _STORAGE_DTYPES[name]
                    raw = bytearray(zf.read(f"{root}data/{key}"))
                    flat = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
                    storages[key] = torch.storage.TypedStorage(
                        wrap_storage=flat.untyped_storage(), dtype=dtype, _internal=True)
                return storages[key]

        return _ZipUnpickler(io.BytesIO(zf.read(pkl[0]))).load()


def state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The tensors of a loaded torch.save payload by name: the payload itself
    when it is a state dict, its "state_dict" entry when it has one (StyleCLIP
    mapper and training checkpoints); entries that are not tensors are dropped."""
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"not a state dict: {type(obj).__name__}")
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a .pt / .pth file by name, on the CPU: the counterpart of
    the JAX `load_torch_state_dict`, read by `load_torch_file_stubbed` so
    nothing from the pickle runs. Unwraps a "state_dict" or "net_recon" entry
    (training checkpoints, Deep3DFaceRecon's epoch_*.pth) and a pickled module
    (its parameters and buffers under their dotted names). Only the torch.save
    zip format is read: a legacy (pre-1.6, non-zip) file raises ValueError."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a torch.save zip file; a legacy (non-zip) torch file is "
                         "not read (re-save it with torch.save from a current PyTorch)")
    obj = load_torch_file_stubbed(path)
    for key in ("state_dict", "net_recon"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if isinstance(obj, dict) and "_parameters" in obj:
        named: Dict[str, np.ndarray] = {}
        _module_named_tensors(obj, "", named)
        return {k: torch.from_numpy(v) for k, v in named.items()}
    return state_dict_of(obj)


def import_bisenet(path: str, device: Union[torch.device, str] = "cuda"):
    """segNet-20Class.pth (a state dict, read with weights_only=True) ->
    BiSeNet(20) on `device`, in eval mode. The checkpoint's auxiliary heads and
    BN counters are not used; a tensor the module needs and the file lacks raises."""
    from ..metrics.features import load_state_dict_file
    from ..models.bisenet import BiSeNet

    return load_state_dict_file(BiSeNet(20), path).to(device).eval()


def _module_named_tensors(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Parameters and buffers of a (stubbed or live) module graph under the
    reference's `named_params_and_buffers` dotted names."""
    st = obj if isinstance(obj, dict) else (getattr(obj, "__dict__", None) or {})
    if "_parameters" not in st and isinstance(st.get("state"), dict):
        st = st["state"]  # a persistent object's reconstruction record
    for bucket in ("_parameters", "_buffers"):
        for name, t in (st.get(bucket) or {}).items():
            if t is None:
                continue
            out[prefix + name] = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    for name, child in (st.get("_modules") or {}).items():
        if child is not None:
            _module_named_tensors(child, f"{prefix}{name}.", out)


def pickle_payload_to_state_dicts(obj) -> Dict[str, Dict[str, np.ndarray]]:
    """A reference checkpoint's object graph (a dict with 'G', 'D', 'G_ema',
    maybe 'E', ...) -> {entry: state dict}; entries without tensors are dropped."""
    out = {}
    if not isinstance(obj, dict):
        obj = {"G": obj}
    for key, val in obj.items():
        if val is None or isinstance(val, (int, float, str, bool)):
            continue
        sd: Dict[str, np.ndarray] = {}
        _module_named_tensors(val, "", sd)
        if sd:
            out[key] = sd
    return out


# --------------------------------------------------------------- name-mapped import


_SKIP_SUFFIXES = ("resample_filter", "num_batches_tracked")


@dataclasses.dataclass
class ImportReport:
    imported: int = 0
    skipped_source: tuple = ()  # state-dict names with no destination
    missing_dest: tuple = ()  # renderer leaves left at their init values
    auto_mapped: tuple = ()  # "src -> dest [xS]" shape-signature matches

    def __str__(self):
        return (
            f"imported {self.imported} tensors; "
            f"{len(self.skipped_source)} source tensors unmapped; "
            f"{len(self.auto_mapped)} shape-auto-mapped; "
            f"{len(self.missing_dest)} destination leaves left initialized"
        )


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a uniform 'module.' prefix (DDP wrapping)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _res_of(sd: Dict[str, np.ndarray], pattern: str) -> list:
    found = set()
    for k in sd:
        m = re.match(pattern, k)
        if m:
            found.add(int(m.group(1)))
    return sorted(found)


def _convert_leaf(name: str, arr: np.ndarray) -> np.ndarray:
    """Torch layout -> the JAX layout the renderer decoder keeps."""
    last = name.rsplit(".", 1)[-1]
    if last == "weight" and arr.ndim == 4:
        return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
    if last == "weight" and arr.ndim == 2:
        return np.ascontiguousarray(arr.T)
    if last == "weight" and arr.ndim == 5:
        return np.ascontiguousarray(np.transpose(arr, (2, 3, 4, 1, 0)))
    return arr


class _Dest:
    """A module's state dict as the destination of an import."""

    def __init__(self, module: nn.Module):
        self.state = module.state_dict()  # shares storage with the module

    def set(self, name: str, arr: np.ndarray) -> None:
        if name not in self.state:
            raise KeyError(f"no destination {name}")
        dst = self.state[name]
        if tuple(dst.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(arr.shape)} vs "
                             f"module {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def _layer_dest(prefix: str, tail: str, arr: np.ndarray):
    """A layer-local reference name (weight, bias, affine.*, noise_*, const)
    -> (the port's name, array); None for any other name."""
    parts = tail.split(".")
    if len(parts) == 2 and parts[0] == "affine" and parts[1] in ("weight", "bias"):
        return prefix + tail, arr
    if len(parts) == 1 and parts[0] in ("weight", "bias", "noise_strength", "noise_const", "const"):
        return prefix + tail, arr
    return None


def _map_block_tensors(sd, src_prefix: str, dst_prefix: str, dest: _Dest, imported: list,
                       skipped: list) -> None:
    """Every tensor under `src_prefix` (e.g. 'synthesis.vb8.') onto the same
    layer names under `dst_prefix`. A shape mismatch raises."""
    for name, arr in sd.items():
        if not name.startswith(src_prefix):
            continue
        tail = name[len(src_prefix):]
        if tail.endswith(_SKIP_SUFFIXES):
            continue
        parts = tail.split(".", 1)
        if len(parts) == 1:
            target = _layer_dest(dst_prefix, parts[0], arr)
        else:
            target = _layer_dest(dst_prefix + parts[0] + ".", parts[1], arr)
        if target is None:
            skipped.append(name)
            continue
        try:
            dest.set(*target)
            imported.append(name)
        except KeyError:
            skipped.append(name)


def _import_mapping(sd, prefix: str, dest: _Dest, imported: list, skipped: list) -> None:
    """The mapping network's FCs and w_avg (the reference may store w_avg
    broadcast to [num_ws, w_dim]); what does not fit is skipped."""
    for name, arr in sd.items():
        if not name.startswith(prefix):
            continue
        tail = name[len(prefix):]
        if tail.endswith(_SKIP_SUFFIXES):
            continue
        parts = tail.split(".")
        if parts[0] == "w_avg":
            target = (prefix + "w_avg", arr[0] if arr.ndim == 2 else arr)
        elif len(parts) == 2 and parts[1] in ("weight", "bias"):
            target = (name, arr)
        else:
            skipped.append(name)
            continue
        try:
            dest.set(*target)
            imported.append(name)
        except (KeyError, ValueError):
            skipped.append(name)


_RENDERER = "synthesis.renderer."


def _renderer_leaves(dest: _Dest) -> list:
    """The renderer decoder's names, in the JAX tree's (sorted) leaf order."""
    return sorted((n for n in dest.state if n.startswith(_RENDERER)), key=lambda n: n.split("."))


def _auto_map_renderer(sd, candidates: list, dest: _Dest, imported: list) -> list:
    """Unnamed source tensors onto the renderer decoder by shape: a (converted)
    shape that occurs once among the candidates and once among the decoder's
    leaves is applied; a 2-D weight whose std is below 0.25 looks like a plain
    nn.Linear and is scaled by sqrt(fan_in), since the decoder applies the
    equalized-lr gain at call time. Returns the "src -> dest [xS]" records."""
    by_shape_dest: Dict[tuple, list] = {}
    for n in _renderer_leaves(dest):
        by_shape_dest.setdefault(tuple(dest.state[n].shape), []).append(n)
    by_shape_src: Dict[tuple, list] = {}
    for name in candidates:
        by_shape_src.setdefault(tuple(_convert_leaf(name, sd[name]).shape), []).append(name)
    applied = []
    for shape, srcs in by_shape_src.items():
        dsts = by_shape_dest.get(shape, [])
        if len(srcs) == 1 and len(dsts) == 1:
            name, target = srcs[0], dsts[0]
            arr = _convert_leaf(name, sd[name]).astype(np.float32)
            scale = 1.0
            if arr.ndim == 2 and float(np.std(arr)) < 0.25:
                scale = float(np.sqrt(arr.shape[0]))
            dest.set(target, arr * scale)
            imported.append(name)
            applied.append(f"{name} -> {target}" + (f" [x{scale:.3g}]" if scale != 1.0 else ""))
    return applied


def import_generator(
    sd: Dict[str, np.ndarray],
    render_size: int = 64,
    num_steps: int = 96,
    dtype: str = "bfloat16",
    extra_map: Optional[Dict[str, Union[str, tuple]]] = None,
    auto_map_renderer: bool = True,
    device: Union[torch.device, str] = "cuda",
):
    """Reference generator state dict -> (Ide3dGenerator on `device`, ImportReport).

    The architecture (resolutions, channels, mapping depth, latent counts) is
    inferred from the state dict and hosted by the reference-compat generator.
    The renderer's decoder has no known reference names: `extra_map`
    ({source name: destination, e.g. "synthesis.renderer.dec_w1"}) routes
    named tensors there (2-D weights transposed to the decoder's [in, out]),
    and with `auto_map_renderer` unambiguous shape matches are recovered;
    decoder leaves left at their seeded init are listed in `missing_dest`.
    """
    from ..models.generator import GeneratorConfig, Ide3dGenerator
    from ..render.renderer import RenderParams

    sd = _strip_prefix(sd)
    n_fc = len(_res_of(sd, r"mapping\.fc(\d+)\.weight$"))
    if n_fc == 0:
        raise ValueError("state dict has no mapping.fc* layers")
    w_dim = int(sd[f"mapping.fc{n_fc - 1}.bias"].shape[0])
    has_embed = "mapping.embed.weight" in sd
    c_dim = int(sd["mapping.embed.weight"].shape[1]) if has_embed else 0
    embed_out = int(sd["mapping.embed.weight"].shape[0]) if has_embed else 0
    if has_embed and embed_out != w_dim:
        raise ValueError(f"mapping.embed out_features {embed_out} != w_dim {w_dim}: "
                         "unsupported embed_features override")
    z_dim = int(sd["mapping.fc0.weight"].shape[1]) - embed_out

    vb_res = _res_of(sd, r"synthesis\.vb(\d+)\.")
    sr_res = _res_of(sd, r"synthesis\.b(\d+)\.")
    if not (vb_res and sr_res):
        raise ValueError("state dict has no synthesis.vb*/b* blocks")
    vb_ch = tuple(int(sd[f"synthesis.vb{r}.conv1.bias"].shape[0]) for r in vb_res)
    sr_ch = tuple(int(sd[f"synthesis.b{r}.conv1.bias"].shape[0]) for r in sr_res)
    cfg = GeneratorConfig(
        z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
        img_resolution=sr_res[-1],
        img_channels=int(sd[f"synthesis.b{sr_res[-1]}.torgb.bias"].shape[0]),
        seg_channels=int(sd[f"synthesis.vb{vb_res[0]}.toseg.bias"].shape[0]) // 3,
        feature_channels=int(sd[f"synthesis.vb{vb_res[0]}.torgb.bias"].shape[0]) // 3,
        render_size=render_size, plane_resolution=vb_res[-1], dtype=dtype,
        render=RenderParams(img_size=render_size, num_steps=num_steps),
        vb_ref_compat=True, raw_head="slice",
        vb_resolutions_override=tuple(vb_res), vb_channels_override=vb_ch,
        sr_resolutions_override=tuple(sr_res), sr_channels_override=sr_ch,
        mapping_num_layers=n_fc,
    )
    G = Ide3dGenerator(cfg).init(0)
    dest = _Dest(G)

    imported: list = []
    skipped: list = []
    _import_mapping(sd, "mapping.", dest, imported, skipped)
    for r in vb_res:
        _map_block_tensors(sd, f"synthesis.vb{r}.", f"synthesis.vb{r}.", dest, imported, skipped)
    for r in sr_res:
        _map_block_tensors(sd, f"synthesis.b{r}.", f"synthesis.b{r}.", dest, imported, skipped)
    for src, target in (extra_map or {}).items():
        if src in sd:
            target = target if isinstance(target, str) else ".".join(target)
            arr = _convert_leaf(src, sd[src]) if target.startswith(_RENDERER) else sd[src]
            dest.set(target, arr)
            imported.append(src)

    handled = set(imported) | set(skipped)
    leftovers = [n for n in sd if n not in handled and not n.endswith(_SKIP_SUFFIXES)]
    auto_mapped: list = []
    if auto_map_renderer and leftovers:
        auto_mapped = _auto_map_renderer(sd, leftovers, dest, imported)
        leftovers = [n for n in leftovers if n not in set(imported)]
    skipped.extend(leftovers)

    auto_dest = {rec.split(" -> ")[1].split(" ")[0] for rec in auto_mapped}
    report = ImportReport(
        imported=len(imported),
        skipped_source=tuple(sorted(skipped)),
        missing_dest=tuple(n for n in _renderer_leaves(dest) if n not in auto_dest),
        auto_mapped=tuple(auto_mapped),
    )
    return G.to(device).eval(), report


def import_discriminator(sd: Dict[str, np.ndarray], dtype: str = "bfloat16",
                         device: Union[torch.device, str] = "cuda"):
    """Reference Discriminator state dict (b{res}.{fromrgb,conv0,conv1,skip},
    mapping.*, b4.{conv,fc,out}) -> (Discriminator on `device`, ImportReport)."""
    from ..models.discriminator import Discriminator, DiscriminatorConfig

    sd = _strip_prefix(sd)
    res = [r for r in _res_of(sd, r"b(\d+)\.") if r > 4]
    if not res:
        raise ValueError("state dict has no b{res} blocks")
    img_resolution = res[-1]
    ch = {r: int(sd[f"b{r}.conv0.bias"].shape[0]) for r in res}
    ch[4] = int(sd["b4.conv.bias"].shape[0])
    channel_max = max(ch.values())
    channel_base = ch[img_resolution] * img_resolution
    # The label mapping has z_dim 0: fc0 takes the label embedding, so c_dim is
    # embed's input width, and its depth is the checkpoint's fc count.
    has_cmap = "mapping.embed.weight" in sd
    n_map_fc = len(_res_of(sd, r"mapping\.fc(\d+)\.weight$")) if has_cmap else 8
    cfg = DiscriminatorConfig(
        c_dim=int(sd["mapping.embed.weight"].shape[1]) if has_cmap else 0,
        img_resolution=img_resolution,
        img_channels=int(sd[f"b{img_resolution}.fromrgb.weight"].shape[1]),
        channel_base=channel_base, channel_max=channel_max,
        cmap_dim=int(sd["mapping.embed.weight"].shape[0]) if has_cmap else None,
        mapping_num_layers=n_map_fc or 8, dtype=dtype,
    )
    for r in res + [4]:
        if min(channel_base // r, channel_max) != ch[r]:
            raise ValueError(f"discriminator channel schedule at b{r} ({ch[r]}) does not follow "
                             f"min({channel_base}//res, {channel_max}); explicit override needed")
    D = Discriminator(cfg).init(0)
    dest = _Dest(D)

    imported: list = []
    skipped: list = []
    sd = dict(sd)
    if "b4.fc.weight" in sd:
        # The reference flattens the 4^2 map in (C, H, W) order, the port in
        # (H, W, C): permute the weight's columns.
        fcw = sd.pop("b4.fc.weight")
        C = int(sd["b4.conv.bias"].shape[0])
        R = int(np.sqrt(fcw.shape[1] // C))
        dest.set("b4.fc.weight", fcw.reshape(fcw.shape[0], C, R, R).transpose(0, 2, 3, 1)
                 .reshape(fcw.shape[0], -1))
        imported.append("b4.fc.weight")
    for r in res:
        _map_block_tensors(sd, f"b{r}.", f"b{r}.", dest, imported, skipped)
    _map_block_tensors(sd, "b4.", "b4.", dest, imported, skipped)
    if cfg.c_dim:
        _import_mapping(sd, "mapping.", dest, imported, skipped)
    report = ImportReport(imported=len(imported), skipped_source=tuple(sorted(skipped)))
    return D.to(device).eval(), report


def import_encoder(sd: Dict[str, np.ndarray], w_dim: int = 512,
                   device: Union[torch.device, str] = "cuda"):
    """Reference Encoder / HybridEncoder state dict -> (module on `device`,
    ImportReport): convs*.0 -> stem, convs*.{i} -> block{i-1}, projector* as is."""
    from ..models.encoder import Encoder, HybridEncoder

    sd = _strip_prefix(sd)
    hybrid = any(k.startswith("convs_img.") for k in sd)

    def blocks(src_convs: str) -> int:
        return len(_res_of(sd, rf"{src_convs}\.(\d+)\.conv1\.weight$"))

    def stream(src_convs: str, src_proj: str) -> tuple:
        return (2 ** (blocks(src_convs) + 2), int(sd[f"{src_convs}.0.weight"].shape[1]),
                int(sd[f"{src_proj}.weight"].shape[0]))

    if hybrid:
        size, img_dim, app_out = stream("convs_img", "projector_img")
        _, seg_dim, geo_out = stream("convs_seg", "projector_seg")
        E = HybridEncoder(size=size, n_latents_app=app_out // w_dim, n_latents_geo=geo_out // w_dim,
                          w_dim=w_dim, input_img_dim=img_dim, input_seg_dim=seg_dim)
        streams = {"img.": ("convs_img", "projector_img"), "seg.": ("convs_seg", "projector_seg")}
    else:
        size, input_dim, out_dim = stream("convs", "projector")
        E = Encoder(size=size, n_latents=out_dim // w_dim, w_dim=w_dim, input_dim=input_dim)
        streams = {"": ("convs", "projector")}
    E.init(0)
    dest = _Dest(E)

    imported: list = []
    skipped: list = []
    for base, (src_convs, src_proj) in streams.items():
        _map_block_tensors(sd, f"{src_convs}.0.", base + "stem.", dest, imported, skipped)
        for i in range(1, blocks(src_convs) + 1):
            _map_block_tensors(sd, f"{src_convs}.{i}.", f"{base}block{i - 1}.", dest, imported,
                               skipped)
        _map_block_tensors(sd, f"{src_proj}.", base + "projector.", dest, imported, skipped)
    report = ImportReport(imported=len(imported), skipped_source=tuple(sorted(skipped)))
    return E.to(device).eval(), report


def load_network_pkl(path: str, device: Union[torch.device, str] = "cuda", **gen_kwargs) -> dict:
    """A reference .pkl -> {'G' | 'G_ema' | 'D' | 'E': (module on `device`,
    ImportReport)} for each entry whose tensors deserialize; an entry that
    fails to import holds its exception. `gen_kwargs` go to import_generator
    (render_size, num_steps, dtype, extra_map, auto_map_renderer). A TF1-era
    pickle, a (G, D, Gs) tuple of tflib Network states, is converted by
    io/tf_legacy.py into {'G', 'D', 'G_ema'} (StyleGan2Generator in fp32, the
    Discriminator in bf16, as in the JAX package); `gen_kwargs` do not apply."""
    from .tf_legacy import convert_tf_payload, is_tf_legacy_payload

    payload = load_pickle_tensors(path)
    if is_tf_legacy_payload(payload):
        return convert_tf_payload(payload, device=device)
    sds = pickle_payload_to_state_dicts(payload)
    # w_dim is not recoverable from an encoder state dict alone (its projector
    # rows are n_latents * w_dim): take it from the generator of the same pkl.
    w_dim = 512
    for gkey in ("G_ema", "G"):
        if gkey in sds and "mapping.fc0.bias" in sds[gkey]:
            n_fc = len(_res_of(sds[gkey], r"mapping\.fc(\d+)\.weight$"))
            w_dim = int(sds[gkey][f"mapping.fc{n_fc - 1}.bias"].shape[0])
            break
    out = {}
    for key, sd in sds.items():
        try:
            if key in ("G", "G_ema"):
                out[key] = import_generator(sd, device=device, **gen_kwargs)
            elif key == "D":
                out[key] = import_discriminator(sd, device=device)
            elif key == "E":
                out[key] = import_encoder(sd, w_dim=w_dim, device=device)
        except Exception as e:  # keep going; each entry reports its own failure
            out[key] = e
    return out
