"""The plain reference of the alias-free (StyleGAN3) superres stack and of a
frame of the G that carries it, in float32 PyTorch.

The layer is the published one (Karras et al., "Alias-Free Generative
Adversarial Networks", NeurIPS 2021; NVlabs/stylegan3
training/networks_stylegan3.py `SynthesisLayer`, as IDE-3D carries it in
inversion/networks.py `SynthesisLayer3`): for input x and latent row w,

    s = A(w)                      (the ToRGB: s / sqrt(Cin))
    x = x * rsqrt(magnitude_ema)
    y = conv(x * s, W) at full padding, times rsqrt(sum_i s_i^2 |W_oi|^2 + 1e-8)
        (3x3; the ToRGB 1x1 and not demodulated)
    filtered_lrelu: add the bias; insert UP - 1 zeros after each pixel; pad;
        the Kaiser low-pass fu along x then y (gain UP each); leaky ReLU
        (slope 0.2, gain sqrt 2; the ToRGB slope 1, gain 1); clamp +-256; the
        low-pass fd along x then y; keep every DOWN-th pixel.

The filters are designed here with scipy from each layer's sampling rates,
cutoffs and transition widths, as the published `design_lowpass_filter` does
(`scipy.signal.firwin`, 6 taps a factor). The stack is the repository's: a
refine layer at the render size, an (upsample, refine) pair an octave,
refines at the output size to 2 layers a superres block, then a 1x1 ToRGB;
the cutoff 0.4 and the half-width 0.1 of each layer's rate; the channels of
the nearest superres block. It reads the state dict by the program's names
and imports nothing of the program; on the card it runs inside generator.py's
`with_tf32_off`, as the video kinds call it.

Departures from the published layer: the stack starts from the rendered
feature image, not from SG3's Fourier-feature input; the sizes carry no
margin (each layer's size is its sampling rate); the weights' and styles'
pre-normalisation before demodulation is left out, which the demodulation
cancels up to its 1e-8; the magnitude EMA is read, never updated.

`quant` (generator.py's `exact`, `STATED`, `LOWER`) is applied where the
configuration's dtype covers: both operands of each convolution, and each
layer's output, which the program keeps in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import generator as ref

CLAMP = 256.0
TAPS_PER_FACTOR = 6
LRELU_UPSAMPLING = 2
CUTOFF, HALF_WIDTH = 0.4, 0.1  # of each layer's sampling rate


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float):
    """The Kaiser low-pass of `numtaps` taps as float32 numpy, None for one tap."""
    import scipy.signal

    if numtaps == 1:
        return None
    return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs).astype(np.float32)


def layer_specs(arch: ref.Arch, filters: bool = True) -> list:
    """Each layer of the stack, the ToRGB last: {name, in/out size and
    channels, kernel k, up, down, up/down taps, padding (x0, x1, y0, y1),
    torgb} and, with `filters`, the filters fu and fd."""
    g = arch.g
    rs, R, srr = g["render_size"], g["img_resolution"], arch.sr_res
    rates = [rs]
    while rates[-1] < R:
        rates.append(rates[-1] * 2)
    pairs = [(rs, rs)]
    for r in rates[:-1]:
        pairs += [(r, 2 * r), (2 * r, 2 * r)]
    n = 2 * len(srr)
    pairs = (pairs + [(R, R)] * n)[:n]

    def channels(res):
        nearest = min(srr, key=lambda b: abs(b - res))
        return min(g["sr_channel_base"] // nearest, g["sr_channel_max"])

    specs, cin = [], arch.fc
    for i, (ri, ro) in enumerate(pairs + [(R, R)]):
        torgb = i == len(pairs)
        cout = g["img_channels"] if torgb else channels(ro)
        tmp = max(ri, ro) * (1 if torgb else LRELU_UPSAMPLING)
        up, down = int(round(tmp / ri)), int(round(tmp / ro))
        up_taps = TAPS_PER_FACTOR * up if up > 1 and not torgb else 1
        down_taps = TAPS_PER_FACTOR * down if down > 1 and not torgb else 1
        k = 1 if torgb else 3
        total = (ro - 1) * down + 1 - (ri + k - 1) * up + up_taps + down_taps - 2
        lo = (total + up) // 2
        specs.append({
            "name": "synthesis.sg3_sr." + ("torgb" if torgb else f"layer{i}"),
            "in_size": ri, "out_size": ro, "cin": cin, "cout": cout, "k": k, "up": up,
            "down": down, "up_taps": up_taps, "down_taps": down_taps, "torgb": torgb,
            "padding": (lo, total - lo, lo, total - lo)})
        if filters:
            specs[-1]["fu"] = design_lowpass_filter(up_taps, CUTOFF * ri, 2 * HALF_WIDTH * ri, tmp)
            specs[-1]["fd"] = design_lowpass_filter(down_taps, CUTOFF * ro, 2 * HALF_WIDTH * ro, tmp)
        cin = cout
    return specs


def _fir(x: torch.Tensor, f, dim: int, gain: float) -> torch.Tensor:
    """True convolution of every channel with the 1-D filter f along `dim`
    (3: x, 2: y), valid part only, times gain."""
    if f is None:
        return x * gain
    C = x.shape[1]
    taps = torch.as_tensor(f[::-1].copy(), device=x.device, dtype=x.dtype) * gain
    shape = (C, 1, 1, len(f)) if dim == 3 else (C, 1, len(f), 1)
    return F.conv2d(x, taps.reshape(1, 1, *shape[2:]).expand(shape), groups=C)


def filtered_lrelu(x, b, spec: dict, gain: float, slope: float) -> torch.Tensor:
    """The zero-insert filtered leaky ReLU of one layer (see the module)."""
    up, down = spec["up"], spec["down"]
    x = x + b[None, :, None, None]
    if up > 1:
        B, C, H, W = x.shape
        z = x.new_zeros(B, C, H * up, W * up)
        z[:, :, ::up, ::up] = x
        x = z
    px0, px1, py0, py1 = spec["padding"]
    x = F.pad(x, [px0, px1, py0, py1])
    x = _fir(_fir(x, spec["fu"], 3, up), spec["fu"], 2, up)
    x = (F.leaky_relu(x, slope) * gain).clamp(-CLAMP, CLAMP)
    x = _fir(_fir(x, spec["fd"], 3, 1.0), spec["fd"], 2, 1.0)
    return x[:, :, ::down, ::down]


def layer(P, spec: dict, x, w, q: Callable) -> torch.Tensor:
    n = spec["name"]
    weight = P[n + ".weight"]
    styles = ref.fc(P, n + ".affine", w)
    if spec["torgb"]:
        styles = styles / math.sqrt(spec["cin"] * spec["k"] ** 2)
    x = x * torch.rsqrt(P[n + ".magnitude_ema"])
    y = F.conv2d(q(x * styles[:, :, None, None]), q(weight), padding=spec["k"] - 1)
    if not spec["torgb"]:
        y = y * torch.rsqrt(styles.square() @ weight.square().sum(dim=(2, 3)).t() + 1e-8)[:, :, None, None]
    gain, slope = (1.0, 1.0) if spec["torgb"] else (math.sqrt(2.0), 0.2)
    return q(filtered_lrelu(y, P[n + ".bias"], spec, gain, slope))


def superres(P, arch: ref.Arch, feature, ws, q: Callable, specs=None) -> torch.Tensor:
    """The stack on the rendered feature image [B, Cf, r, r] -> img [B, 3, R, R]."""
    if arch.ref_compat:
        base = arch.vb_rows + (1 if arch.raw_torgb else 0)
    else:
        base = len(arch.vb_res) + 2
    x = q(feature)
    for i, spec in enumerate(specs or layer_specs(arch)):
        x = layer(P, spec, x, ws[:, base + i], q)
    return x


def frame(P, arch: ref.Arch, ws: torch.Tensor, c: torch.Tensor, q: Callable = ref.exact,
          specs=None) -> dict:
    """ws [B, num_ws, w_dim], c [B, 25] -> {"img": [B, R, R, 3], "seg": [B, R, R, Cs]}:
    generator.py's planes and render, this stack, the seg upsampled."""
    img_v, seg_v = ref.planes(P, arch, ws.float(), q)
    feature, seg = ref.render(P, arch, q(img_v), q(seg_v), c)
    img = superres(P, arch, feature, ws.float(), q, specs)
    R = arch.g["img_resolution"]
    seg = F.interpolate(seg, size=(R, R), mode="bilinear", align_corners=False)
    return {"img": img.permute(0, 2, 3, 1), "seg": seg.permute(0, 2, 3, 1)}


def frame_u8(P, arch: ref.Arch, ws, c, q: Callable = ref.exact, specs=None) -> np.ndarray:
    """The video tile of each frame: uint8 [B, R, 2R, 3], the image beside its colored seg."""
    out = frame(P, arch, ws, c, q, specs)
    img8 = torch.round((out["img"] + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    seg8 = ref.PALETTE[out["seg"].argmax(dim=-1).cpu().numpy()]
    return np.concatenate([img8, seg8], axis=2)
