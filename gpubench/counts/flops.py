"""Convolution and matrix-product FLOPs of the work a cell does, from the
configuration's sizes alone (2 FLOPs a multiply-add).

A frame of the generator: the vb stack's modulated convolutions with their
style affines, demodulation products, FIR up-sampling filters, ToRGB / ToSEG
heads and SPADE 1x1 convolutions; the decoder MLP at every coarse and fine
sample; the raw head and the superres blocks. The sort, composite, tri-plane
lookups and element-wise work are not counted.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core rate, NVIDIA's data sheet
FIR_TAPS = 16  # the 4x4 [1, 3, 3, 1] filter


def _octaves(lo: int, hi: int) -> list:
    out = []
    while lo <= hi:
        out.append(lo)
        lo *= 2
    return out


def _affine(w: int, cin: int) -> int:
    return 2 * w * cin


def _mod_conv(w: int, cin: int, cout: int, res: int, up: int, k: int = 3) -> int:
    """A modulated conv at output size res: affine, demodulation, FIR (up), conv."""
    n = _affine(w, cin) + 2 * cin * cout * k * k * res * res
    if k > 1:
        n += 2 * cin * cout  # demodulation coefficients
    if up > 1:
        n += 2 * cin * FIR_TAPS * (res + 2) ** 2
    return n


def _upsample(ch: int, res: int) -> int:
    return 2 * ch * FIR_TAPS * res * res


def generator_frame(config: dict) -> int:
    g = config["generator"]
    w, fc, sc = g["w_dim"], g["feature_channels"], g["seg_channels"]
    vb_res = _octaves(4, g["plane_resolution"])
    sr_res = _octaves(g["render_size"], g["img_resolution"])

    def vb_ch(r):
        return min(g["channel_base"] // r, g["channel_max"])

    def sr_ch(r):
        return min(g["sr_channel_base"] // r, g["sr_channel_max"])

    n = 0
    for i, r in enumerate(vb_res):
        cout = vb_ch(r)
        if g["vb_ref_compat"]:
            if i > 0:
                n += _mod_conv(w, vb_ch(vb_res[i - 1]), cout, r, 2)
            n += _mod_conv(w, cout, cout, r, 1)
        else:
            cin = cout if i == 0 else vb_ch(vb_res[i - 1])
            n += _mod_conv(w, cin, cout, r, 1 if i == 0 else 2)
            n += 2 * 2 * (3 * sc) * cout * r * r  # SPADE gamma and beta
        n += _mod_conv(w, cout, 3 * fc, r, 1, k=1) + _mod_conv(w, cout, 3 * sc, r, 1, k=1)
        if i > 0:
            n += _upsample(3 * fc, r) + _upsample(3 * sc, r)

    rp = g["render"]
    points = rp["img_size"] ** 2 * (rp["num_steps"] + (rp["fine_steps"] or rp["num_steps"]))
    n += points * (2 * fc * 64 + 2 * 64 * (fc + 1))

    rs = g["render_size"]
    if g["raw_head"] == "torgb":
        n += _mod_conv(w, fc, g["img_channels"], rs, 1, k=1)
    for i, r in enumerate(sr_res):
        cin = fc if i == 0 else sr_ch(sr_res[i - 1])
        up = 1 if (i == 0 and r == rs) else 2
        n += _mod_conv(w, cin, sr_ch(r), r, up) + _mod_conv(w, sr_ch(r), sr_ch(r), r, 1)
        n += _mod_conv(w, sr_ch(r), g["img_channels"], r, 1, k=1)
        if up > 1:
            n += _upsample(g["img_channels"], r)
    return n


ENCODER_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32,
                    1024: 16}


def _down_conv(cin: int, cout: int, res: int, k: int) -> int:
    """A k x k conv with FIR 2x down-sampling from res: the FIR on the padded
    image (res + 2 (k // 2) - 1 a side), then the strided conv."""
    fir = res + 2 * (k // 2) - 1
    return 2 * cin * FIR_TAPS * fir * fir + 2 * cin * cout * k * k * (res // 2) ** 2


def encoder_pass(config: dict) -> int:
    """One image through the HybridEncoder: an image and a seg pyramid, each
    a 1x1 stem, residual blocks down to 4^2 and the 4x4 projector."""
    e = config["encoder"]
    n = 0
    for cin, rows in ((e["input_img_dim"], e["n_latents_app"]), (e["input_seg_dim"], e["n_latents_geo"])):
        r = e["size"]
        n += 2 * cin * ENCODER_CHANNELS[r] * r * r
        while r > 4:
            c, c2 = ENCODER_CHANNELS[r], ENCODER_CHANNELS[r // 2]
            n += 2 * c * c * 9 * r * r + _down_conv(c, c2, r, 3) + _down_conv(c, c2, r, 1)
            r //= 2
        n += 2 * ENCODER_CHANNELS[4] * rows * e["w_dim"] * 16
    return n


def work_flops(config: dict, work: dict) -> int:
    """FLOPs of a window's work: {"g_frames": frames of the generator,
    "e_passes": images through the encoder, "flops": FLOPs counted otherwise}."""
    n = work.get("g_frames", 0) * generator_frame(config) + work.get("flops", 0)
    if work.get("e_passes"):
        n += work["e_passes"] * encoder_pass(config)
    return n
