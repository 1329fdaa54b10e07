"""The StyleGAN3 alias-free synthesis layer (the reference's SynthesisLayer3).

Counterpart of ide3d_tpu/models/layers_sg3.py: a modulated conv (3x3, or 1x1
for the ToRGB) at full padding, then `filtered_lrelu` (the bias, the FIR
upsample, the leaky ReLU, the FIR downsample) with low-pass filters designed
per layer from its sampling rates, cutoffs and transition half-widths; the
input is scaled by rsqrt(magnitude_ema). `design_lowpass_filter` (Kaiser
through scipy.signal.firwin, or the radial jinc) and `sg3_layer_schedule` are
numpy, as in the JAX package. Activations are NCHW, conv weights OIHW; the
weights are N(0, 1) and demodulated (the ToRGB's styles carry its gain).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.filtered_lrelu import filtered_lrelu
from ..ops.modulated_conv import modulated_conv2d
from .layers import FullyConnectedLayer

# The reference's SynthesisLayer defaults, the only values the generator uses.
CONV_KERNEL = 3  # the ToRGB's is 1
FILTER_TAPS = 6  # per up/down factor
LRELU_UPSAMPLING = 2
CONV_CLAMP = 256.0


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """Kaiser (or radial jinc) low-pass design (networks.py:634-655); None for one tap."""
    import scipy.signal
    import scipy.special

    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[np.isnan(f)] = cutoff * 2  # the limit at r = 0
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return np.asarray(f, np.float32)


class SynthesisLayer3(nn.Module):
    """Alias-free layer (networks.py:519-632): forward(x [B, in, in_size, in_size],
    w [B, w_dim]) -> [B, out, out_size, out_size] in x's dtype."""

    def __init__(self, w_dim: int, is_torgb: bool, in_channels: int, out_channels: int,
                 in_size: int, out_size: int, in_sampling_rate: float, out_sampling_rate: float,
                 in_cutoff: float, out_cutoff: float, in_half_width: float, out_half_width: float):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels = in_channels
        self.conv_kernel = 1 if is_torgb else CONV_KERNEL
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else LRELU_UPSAMPLING)

        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        up_taps = FILTER_TAPS * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        down_taps = FILTER_TAPS * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        fd = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2, tmp_rate)
        self.register_buffer("up_filter", None if fu is None else torch.from_numpy(fu),
                             persistent=False)
        self.register_buffer("down_filter", None if fd is None else torch.from_numpy(fd),
                             persistent=False)
        # Padding w.r.t. the upsampled image (networks.py:591-597).
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = (pad_lo, pad_hi, pad_lo, pad_hi)

        k = self.conv_kernel
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.magnitude_ema = nn.Parameter(torch.ones(()))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            self.bias.zero_()
            self.magnitude_ema.fill_(1.0)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w.float())
        if self.is_torgb:
            styles = styles * (1.0 / np.sqrt(self.in_channels * self.conv_kernel**2))
        x = x * torch.rsqrt(self.magnitude_ema).to(x.dtype)
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, padding=self.conv_kernel - 1,
                             demodulate=not self.is_torgb)
        return filtered_lrelu(
            x, self.up_filter, self.down_filter, self.bias.to(x.dtype),
            up=self.up_factor, down=self.down_factor, padding=self.padding,
            gain=1.0 if self.is_torgb else np.sqrt(2.0), slope=1.0 if self.is_torgb else 0.2,
            clamp=CONV_CLAMP)

    def update_magnitude_ema(self, x: torch.Tensor, beta: float = 0.999) -> torch.Tensor:
        """The EMA of the input's mean square after one more input `x`
        (returned, not stored), without gradient through `x`."""
        mag = x.detach().float().square().mean()
        return mag + (self.magnitude_ema - mag) * beta


def sg3_layer_schedule(num_layers: int = 14, img_resolution: int = 512, first_cutoff: float = 2.0,
                       first_stopband: float = 2.0**2.1, last_stopband_rel: float = 2.0**0.3,
                       margin_size: int = 10) -> dict:
    """The StyleGAN3 per-layer (size, sampling_rate, cutoff, half_width) schedule."""
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - 1), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + margin_size * 2
    sizes[-2:] = img_resolution
    return {"sizes": sizes, "sampling_rates": sampling_rates,
            "cutoffs": cutoffs, "half_widths": half_widths}
