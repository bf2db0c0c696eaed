"""VGG16 conv features for LPIPS and the perceptual loss.

Port of egom2p_tpu/core/vgg_features.py.  Weights are a dict with
`conv{i}_w` (kh, kw, cin, cout) and `conv{i}_b` for the 13 conv layers
(i = 0..12), the JAX package's `lpips_vgg.npz` layout; the five LPIPS taps
are after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 (Zhang et al.
2018).  Inputs are channel-last in [-1, 1] ((B, H, W, C) frames or
(B, T, H, W, C) clips, time folded into the batch; one channel is repeated
to three); the LPIPS shift / scale is applied inside.  Features come back
channel-last.

`vgg16_features_torch` is differentiable (the perceptual loss trains
through it) and runs where its input lies; `vgg16_features` takes and
returns numpy.  On the card the convolutions run in exact fp32 (the JAX
package's precision), not on cuDNN's TF32 default.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from egom2p_torch.core.image_ops import exact_fp32

# conv layers per VGG16 block; a tap at each block's end
_BLOCKS = (2, 2, 3, 3, 3)
_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def random_weights(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Seeded random lpips_vgg.npz contents at the published shapes (He-normal
    convolutions, zero biases, uniform [0, 0.1) linear weights): for running
    the metric where no published file is at hand; its values mean
    nothing."""
    w, cin = {}, 3
    for i, cout in enumerate(_CHANNELS):
        w[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, cout)) * (2 / (9 * cin)) ** 0.5
                           ).astype(np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        cin = cout
    for i, c in enumerate((64, 128, 256, 512, 512)):
        w[f"lin{i}"] = rng.uniform(0, 0.1, c).astype(np.float32)
    return w


def conv_weights(weights: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The npz's conv{i}_w (kh, kw, cin, cout) as torch's (cout, cin, kh, kw)
    and conv{i}_b, fp32 on `device`."""
    out = {}
    for i in range(sum(_BLOCKS)):
        w = torch.as_tensor(np.asarray(weights[f"conv{i}_w"], dtype=np.float32))
        out[f"conv{i}_w"] = w.permute(3, 2, 0, 1).contiguous().to(device)
        out[f"conv{i}_b"] = torch.as_tensor(
            np.asarray(weights[f"conv{i}_b"], dtype=np.float32)).to(device)
    return out


def vgg16_features_torch(x: torch.Tensor, weights: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The 5 tap features (B, H, W, C) of x in [-1, 1]; `weights` from
    conv_weights on x's device."""
    if x.dim() == 5:
        x = x.reshape(-1, *x.shape[2:])
    if x.shape[-1] == 1:  # depth -> 3 channels
        x = x.repeat(1, 1, 1, 3)
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=x.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=x.device)
    x = ((x.float() - shift) / scale).permute(0, 3, 1, 2)
    feats, i = [], 0
    for b, n_convs in enumerate(_BLOCKS):
        for _ in range(n_convs):
            x = F.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"], padding=1))
            i += 1
        feats.append(x.permute(0, 2, 3, 1))
        if b < len(_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def vgg16_features(x, weights: Dict[str, np.ndarray], device="cuda") -> List[np.ndarray]:
    """numpy in, numpy out: the 5 tap features of x computed on `device`."""
    from egom2p_torch.core.device import resolve_device
    device = resolve_device(device)
    with torch.no_grad(), exact_fp32():
        xt = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
        return [f.cpu().numpy() for f in vgg16_features_torch(xt, conv_weights(weights, device))]
