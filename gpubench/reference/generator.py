"""The plain reference of an IDE-3D frame: mapping, tri-plane (vb) stack,
volume render with the merged sort-and-composite, raw head, superres and the
seg upsample, in float32 PyTorch.

It reads a state dict by the parameter names of the benchmark's configurations
and imports nothing of the program. It follows the published generator: the
SPADE-conditioned vb interior of the flagship, or the reference checkpoint's
two-conv interior with its w-row slicing (`vb_ref_compat`), StyleGAN2's
modulated convolutions with FIR up-sampling, a 2-layer decoder on the summed
tri-plane samples, stratified coarse samples, deterministic inverse-CDF
importance samples, and alpha compositing of the depth-sorted union of both.

`quant` is applied to every operand of the conv stacks and to the planes that
the renderer samples, the parts that the configuration's `dtype` covers:
`exact` for the reference, `STATED[dtype]` for the reference rounded at the
stated precision (TF32 for float32, since exact float32 would be the
reference itself), `LOWER[dtype]` for the control one precision below.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
CONV_CLAMP = 256.0
LAST_DELTA = 1e10
E4M3_MAX = 448.0
PALETTE = np.array(
    [[0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255], [204, 0, 204],
     [0, 255, 255], [255, 204, 204], [102, 51, 0], [255, 0, 0], [102, 204, 0], [255, 255, 0],
     [0, 0, 153], [0, 0, 204], [255, 51, 153], [0, 204, 204], [0, 51, 0], [255, 153, 51],
     [0, 204, 0]], dtype=np.uint8)


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round trip through bfloat16."""
    return t.to(torch.bfloat16).float()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round trip through float8 e4m3 with one scale a tensor (amax to 448)."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32's 10 mantissa bits (to nearest, ties away)."""
    b = t.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


STATED = {"bfloat16": bf16, "float32": tf32}
LOWER = {"bfloat16": fp8, "float32": bf16}


class Arch:
    """The sizes of a configuration file's `generator` section."""

    def __init__(self, g: dict):
        self.g = g
        self.ref_compat = bool(g["vb_ref_compat"])
        self.raw_torgb = g["raw_head"] == "torgb"
        self.vb_res = _octaves(4, g["plane_resolution"])
        self.sr_res = _octaves(g["render_size"], g["img_resolution"])
        self.fc, self.sc = g["feature_channels"], g["seg_channels"]
        self.render = g["render"]

    @property
    def vb_rows(self) -> int:
        """w rows the vb convs advance (the reference's sum of num_conv)."""
        return 1 + 2 * (len(self.vb_res) - 1) if self.ref_compat else len(self.vb_res)

    @property
    def num_ws(self) -> int:
        if self.ref_compat:
            return self.vb_rows + 2 * len(self.sr_res) + 1 + (1 if self.raw_torgb else 0)
        return len(self.vb_res) + 2 + 2 * len(self.sr_res) + 1


def _octaves(lo: int, hi: int) -> list:
    out = []
    while lo <= hi:
        out.append(lo)
        lo *= 2
    return out


# ------------------------------------------------------------------ layers


def _fir(device) -> torch.Tensor:
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def upfirdn2d(x, up: int, pad: tuple, gain: float, q: Callable) -> torch.Tensor:
    """Zero insertion by `up`, padding (x0, x1, y0, y1), the 4x4 [1,3,3,1] FIR
    as a true convolution scaled by `gain`."""
    B, C, H, W = x.shape
    if up > 1:
        x = F.pad(x.reshape(B, C, H, 1, W, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(B, C, H * up, W * up)
    x = F.pad(x, list(pad))
    f = (_fir(x.device) * gain).flip([0, 1])
    return F.conv2d(q(x), q(f)[None, None].repeat(C, 1, 1, 1), groups=C)


def upsample2d(x, q: Callable) -> torch.Tensor:
    return upfirdn2d(x, 2, (2, 1, 2, 1), 4.0, q)


def conv(x, w, up: int, q: Callable) -> torch.Tensor:
    """3x3 (or 1x1) convolution, 'same' size, or with FIR 2x up-sampling."""
    if up == 1:
        return F.conv2d(q(x), q(w), padding=w.shape[-1] // 2)
    x = upfirdn2d(x, 2, (3, 2, 3, 2), 4.0, q)
    return F.conv2d(q(x), q(w.flip([2, 3])))


def fc(P, name, x, lr: float = 1.0, act: bool = False) -> torch.Tensor:
    w = P[name + ".weight"]
    y = x @ (w * (lr / math.sqrt(w.shape[1]))).t() + P[name + ".bias"] * lr
    return F.leaky_relu(y, 0.2) * SQRT2 if act else y


def synthesis_layer(P, name, x, w, up: int, q: Callable) -> torch.Tensor:
    styles = fc(P, name + ".affine", w)
    weight = P[name + ".weight"]
    x = conv(x * styles[:, :, None, None], weight, up, q)
    d = torch.rsqrt(styles.square() @ weight.square().sum(dim=(2, 3)).t() + 1e-8)
    x = x * d[:, :, None, None] + (P[name + ".noise_const"] * P[name + ".noise_strength"])[None, None]
    x = F.leaky_relu(x + P[name + ".bias"][None, :, None, None], 0.2) * SQRT2
    return x.clamp(-CONV_CLAMP, CONV_CLAMP)


def torgb(P, name, x, w, q: Callable) -> torch.Tensor:
    weight = P[name + ".weight"]
    styles = fc(P, name + ".affine", w) / math.sqrt(weight.shape[1])
    x = conv(x * styles[:, :, None, None], weight, 1, q)
    return (x + P[name + ".bias"][None, :, None, None]).clamp(-CONV_CLAMP, CONV_CLAMP)


def conv1x1(P, name, x, q: Callable) -> torch.Tensor:
    weight = P[name + ".weight"]
    return conv(x, weight / math.sqrt(weight.shape[1]), 1, q) + P[name + ".bias"][None, :, None, None]


# ----------------------------------------------------------------- mapping


def _norm2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


def mapping(P, arch: Arch, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """z [B, z_dim], c [B, 25] -> ws [B, num_ws, w_dim] (no truncation)."""
    x = torch.cat([_norm2(z.float()), _norm2(fc(P, "mapping.embed", c.float()))], dim=-1)
    for i in range(arch.g["mapping_num_layers"]):
        x = fc(P, f"mapping.fc{i}", x, lr=0.01, act=True)
    return x[:, None].expand(-1, arch.num_ws, -1)


# ------------------------------------------------------------------ planes


def planes(P, arch: Arch, ws: torch.Tensor, q: Callable) -> tuple:
    """The vb stack -> (texture planes [B, 3*Cf, H, W], semantic planes [B, 3*Cs, H, W])."""
    x = img_v = seg_v = None
    B = ws.shape[0]
    row = 0
    for i, res in enumerate(arch.vb_res):
        n = f"synthesis.vb{res}"
        if arch.ref_compat:
            if i == 0:
                x = P[n + ".const"][None].expand(B, -1, -1, -1)
            else:
                x = synthesis_layer(P, n + ".conv0", x, ws[:, row], 2, q)
                row += 1
            x = synthesis_layer(P, n + ".conv1", x, ws[:, row], 1, q)
            row += 1
            w_head = ws[:, row]
            if img_v is not None:
                img_v, seg_v = upsample2d(img_v, q), upsample2d(seg_v, q)
            y, s = torgb(P, n + ".torgb", x, w_head, q), torgb(P, n + ".toseg", x, w_head, q)
            img_v = y if img_v is None else img_v + y
            seg_v = s if seg_v is None else seg_v + s
            continue
        w_head = ws[:, len(arch.vb_res)]
        if i == 0:
            x = synthesis_layer(P, n + ".conv", P[n + ".const"][None].expand(B, -1, -1, -1), ws[:, 0], 1, q)
        else:
            x = synthesis_layer(P, n + ".conv", x, ws[:, i], 2, q)
            img_v, seg_v = upsample2d(img_v, q), upsample2d(seg_v, q)
        s = torgb(P, n + ".toseg", x, w_head, q)
        seg_v = s if seg_v is None else seg_v + s
        x_tex = x * (1.0 + conv1x1(P, n + ".spade_gamma", seg_v, q)) + conv1x1(P, n + ".spade_beta", seg_v, q)
        y = torgb(P, n + ".torgb", x_tex, w_head, q)
        img_v = y if img_v is None else img_v + y
    return img_v, seg_v


# ------------------------------------------------------------------ render


def _sample(P, arch: Arch, img_v, seg_v, pts: torch.Tensor) -> torch.Tensor:
    """World points [B, N, 3] -> [B, N, Cf + Cs + 1]: the three planes'
    bilinear samples summed, the decoder on the features, sigma last."""
    fc_, sc = arch.fc, arch.sc
    x, y, z = pts.unbind(-1)
    acc = None
    for k, (u, v) in enumerate(((x, y), (y, z), (x, z))):
        plane = torch.cat([img_v[:, k * fc_:(k + 1) * fc_], seg_v[:, k * sc:(k + 1) * sc]], dim=1)
        s = F.grid_sample(plane, torch.stack([u, v], -1)[:, None], mode="bilinear",
                          padding_mode="zeros", align_corners=False)[:, :, 0]
        acc = s if acc is None else acc + s
    acc = acc.transpose(1, 2)
    feat, seg = acc[..., :fc_], acc[..., fc_:]
    w1, w2 = P["synthesis.renderer.dec_w1"], P["synthesis.renderer.dec_w2"]
    h = F.leaky_relu(feat @ (w1 / math.sqrt(w1.shape[0])) + P["synthesis.renderer.dec_b1"], 0.2) * SQRT2
    dec = h @ (w2 / math.sqrt(w2.shape[0])) + P["synthesis.renderer.dec_b2"]
    return torch.cat([dec[..., :fc_], seg, dec[..., -1:]], dim=-1)


def _composite(z: torch.Tensor, vals: torch.Tensor, ray_norm: torch.Tensor) -> torch.Tensor:
    """Alpha compositing of samples in any depth order ([B, R, S], [B, R, S, C+1],
    |ray direction| [R]) -> features [B, R, C]: stable depth sort, the last
    delta 1e10, softplus density."""
    zs, order = torch.sort(z, dim=-1, stable=True)
    density = F.softplus(torch.gather(vals[..., -1], -1, order))
    nxt = torch.cat([zs[..., 1:], zs[..., -1:]], dim=-1)
    deltas = nxt - zs
    deltas[..., -1] = LAST_DELTA
    x = deltas * ray_norm[None, :, None] * density
    log_t = torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(-x[..., :-1], dim=-1)], dim=-1)
    w_sorted = (1.0 - torch.exp(-x)) * torch.exp(log_t)
    w = torch.empty_like(w_sorted).scatter_(-1, order, w_sorted)
    return torch.einsum("brs,brsc->brc", w, vals[..., :-1])


def render(P, arch: Arch, img_v, seg_v, c: torch.Tensor) -> tuple:
    """-> (features [B, Cf, r, r], semantics [B, Cs, r, r]) of the cameras in c."""
    rp = arch.render
    B, r, S = c.shape[0], rp["img_size"], rp["num_steps"]
    dev = c.device
    xs = torch.linspace(-1.0, 1.0, r, device=dev)
    ys = torch.linspace(1.0, -1.0, r, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    zf = -torch.ones_like(xg) / math.tan(math.radians(rp["fov"]) / 2)
    d_cam = torch.stack([xg, yg, zf], -1).reshape(-1, 3)
    d_cam = d_cam / (d_cam.norm(dim=-1, keepdim=True) + 1e-9)
    z_vals = torch.linspace(rp["ray_start"], rp["ray_end"], S, device=dev)
    c2w = c[:, :16].reshape(B, 4, 4).float()
    rot, origin = c2w[:, :3, :3], c2w[:, :3, 3]
    dirs = torch.einsum("bij,rj->bri", rot, d_cam)  # [B, R, 3]
    ray_norm = d_cam.norm(dim=-1)  # [R]

    def samples(depths):  # [B, R, K] -> [B, R, K, C+1]
        pts = origin[:, None, None] + dirs[:, :, None] * depths[..., None]
        out = _sample(P, arch, img_v, seg_v, pts.reshape(B, -1, 3))
        return out.reshape(B, r * r, depths.shape[-1], -1)

    zc = z_vals.expand(B, r * r, S)
    coarse = samples(zc)
    # Coarse weights (sorted depths), then the importance depths on the mid-points.
    deltas = torch.cat([zc[..., 1:] - zc[..., :-1], torch.full_like(zc[..., :1], LAST_DELTA)], -1)
    alphas = 1.0 - torch.exp(-deltas * ray_norm[None, :, None] * F.softplus(coarse[..., -1]))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], -1), -1)
    weights = (alphas * trans[..., :-1])[..., 1:-1].reshape(B * r * r, S - 2) + 1e-5
    mids = (0.5 * (zc[..., 1:] + zc[..., :-1])).reshape(B * r * r, S - 1)
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1).contiguous()
    n_fine = rp.get("fine_steps") or S
    u = torch.linspace(0.0, 1.0, n_fine, device=dev).expand(cdf.shape[0], n_fine).contiguous()
    idx = torch.searchsorted(cdf, u, right=False)
    lo, hi = (idx - 1).clamp(0, S - 2), idx.clamp(0, S - 2)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    b0, b1 = mids.gather(1, lo), mids.gather(1, hi)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    zf_ = (b0 + (u - c0) / den * (b1 - b0)).reshape(B, r * r, n_fine)
    fine = samples(zf_)
    comp = _composite(torch.cat([zc, zf_], -1), torch.cat([coarse, fine], -2), ray_norm)
    comp = comp.reshape(B, r, r, -1).permute(0, 3, 1, 2)
    return comp[:, :arch.fc], comp[:, arch.fc:arch.fc + arch.sc]


# ------------------------------------------------------------------- frame


def superres(P, arch: Arch, feature, ws, q: Callable) -> tuple:
    """-> (img [B, 3, R, R], raw [B, 3, r, r])."""
    if arch.raw_torgb:
        raw_row = arch.vb_rows if arch.ref_compat else len(arch.vb_res) + 1
        raw = torgb(P, "synthesis.raw_rgb", feature, ws[:, raw_row], q)
    else:
        raw = feature[:, :3]
    if arch.ref_compat:
        base = arch.vb_rows + (1 if arch.raw_torgb else 0)
    else:
        base = len(arch.vb_res) + 2
    x, img = feature, raw
    for i, res in enumerate(arch.sr_res):
        n, r0 = f"synthesis.b{res}", base + 2 * i
        up = 1 if (i == 0 and res == arch.g["render_size"]) else 2
        x = synthesis_layer(P, n + ".conv0", x, ws[:, r0], up, q)
        x = synthesis_layer(P, n + ".conv1", x, ws[:, r0 + 1], 1, q)
        if up > 1:
            img = upsample2d(img, q)
        img = img + torgb(P, n + ".torgb", x, ws[:, min(r0 + 2, arch.num_ws - 1)], q)
    return img, raw


def frame(P, arch: Arch, ws: torch.Tensor, c: torch.Tensor, q: Callable = exact) -> dict:
    """ws [B, num_ws, w_dim], c [B, 25] -> {"img": [B, R, R, 3], "seg": [B, R, R, Cs]} float32."""
    img_v, seg_v = planes(P, arch, ws.float(), q)
    img_v, seg_v = q(img_v), q(seg_v)
    feature, seg = render(P, arch, img_v, seg_v, c)
    img, _ = superres(P, arch, feature, ws.float(), q)
    R = arch.g["img_resolution"]
    seg = F.interpolate(seg, size=(R, R), mode="bilinear", align_corners=False)
    return {"img": img.permute(0, 2, 3, 1), "seg": seg.permute(0, 2, 3, 1)}


def frame_u8(P, arch: Arch, ws, c, q: Callable = exact) -> np.ndarray:
    """The video tile of each frame: uint8 [B, R, 2R, 3], the image beside its colored seg."""
    out = frame(P, arch, ws, c, q)
    img8 = torch.round((out["img"] + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    seg8 = PALETTE[out["seg"].argmax(dim=-1).cpu().numpy()]
    return np.concatenate([img8, seg8], axis=2)


def load_params(state: dict, device, dtype=torch.float32) -> dict:
    return {k: v.detach().to(device=device, dtype=dtype) for k, v in state.items()}


@contextlib.contextmanager
def tf32_off():
    """TF32 off in matmuls and cuDNN convolutions inside, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def with_tf32_off(fn: Callable, *args, **kw):
    """fn(...) without gradients and with TF32 off."""
    with tf32_off(), torch.no_grad():
        return fn(*args, **kw)
