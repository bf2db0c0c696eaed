"""InceptionV3 features and class logits for FID and the Inception score.

Port of egom2p_tpu/core/inception_v3.py (reference: run_training_vqvae.py:
1563-1586, torchmetrics' FID on pool3 features and InceptionScore on
`logits_unbiased`).  Both graphs of the JAX module, chosen by the fc's
width (`detect_variant`):

  * "fid" (1008 classes, pytorch-fid's pt_inception weights): input in
    [0, 1] scaled to [-1, 1], average pools that exclude the padding, a max
    branch pool in Mixed_7c;
  * "torchvision" (1000 classes): ImageNet mean / std, average pools that
    count the padding.

Weights are the flat dict of state-dict arrays under their torch names
(`Mixed_5b.branch1x1.conv.weight`, `...bn.running_mean`, `fc.weight`):
the JAX package's `inception_v3.npz`, which `convert_inception_pth`
writes from a local torchvision checkpoint.  Inputs are channel-last
(B, H, W, C) in [0, 1]; they are resized to 299 x 299 bilinearly inside
(antialiased when they shrink, as jax.image.resize), one channel repeated
to three.  The network runs in exact fp32 wherever its input lies (the
card's default TF32 convolutions are turned off inside).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from egom2p_torch.core.image_ops import exact_fp32, resize_bilinear

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_bn(x, w: Dict[str, torch.Tensor], name: str, stride: int = 1, same: bool = True):
    """BasicConv2d: conv (no bias) -> BN (eps 1e-3, running stats) -> relu;
    NCHW.  SAME pads each side by (k - 1) / 2 (every SAME conv here has
    stride 1 and odd kernels)."""
    kern = w[f"{name}.conv.weight"]
    pad = (kern.shape[2] // 2, kern.shape[3] // 2) if same else 0
    x = F.conv2d(x, kern, stride=stride, padding=pad)
    scale = w[f"{name}.bn.weight"] * torch.rsqrt(w[f"{name}.bn.running_var"] + 1e-3)
    x = (x - w[f"{name}.bn.running_mean"][:, None, None]) * scale[:, None, None]
    return F.relu(x + w[f"{name}.bn.bias"][:, None, None])


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3(x, exclude_pad: bool):
    """3 x 3 stride-1 SAME average pool; exclude_pad divides border windows
    by their valid count (pytorch-fid's count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not exclude_pad)


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _inception_a(x, w, name, ep):
    b1 = _conv_bn(x, w, f"{name}.branch1x1")
    b5 = _conv_bn(_conv_bn(x, w, f"{name}.branch5x5_1"), w, f"{name}.branch5x5_2")
    b3 = _conv_bn(x, w, f"{name}.branch3x3dbl_1")
    b3 = _conv_bn(_conv_bn(b3, w, f"{name}.branch3x3dbl_2"), w, f"{name}.branch3x3dbl_3")
    bp = _conv_bn(_avgpool3(x, ep), w, f"{name}.branch_pool")
    return _cat(b1, b5, b3, bp)


def _inception_b(x, w, name):
    b3 = _conv_bn(x, w, f"{name}.branch3x3", stride=2, same=False)
    bd = _conv_bn(_conv_bn(x, w, f"{name}.branch3x3dbl_1"), w, f"{name}.branch3x3dbl_2")
    bd = _conv_bn(bd, w, f"{name}.branch3x3dbl_3", stride=2, same=False)
    return _cat(b3, bd, _maxpool(x))


def _inception_c(x, w, name, ep):
    b1 = _conv_bn(x, w, f"{name}.branch1x1")
    b7 = x
    for i in (1, 2, 3):
        b7 = _conv_bn(b7, w, f"{name}.branch7x7_{i}")
    bd = x
    for i in (1, 2, 3, 4, 5):
        bd = _conv_bn(bd, w, f"{name}.branch7x7dbl_{i}")
    bp = _conv_bn(_avgpool3(x, ep), w, f"{name}.branch_pool")
    return _cat(b1, b7, bd, bp)


def _inception_d(x, w, name):
    b3 = _conv_bn(_conv_bn(x, w, f"{name}.branch3x3_1"), w, f"{name}.branch3x3_2",
                  stride=2, same=False)
    b7 = x
    for i in (1, 2, 3):
        b7 = _conv_bn(b7, w, f"{name}.branch7x7x3_{i}")
    b7 = _conv_bn(b7, w, f"{name}.branch7x7x3_4", stride=2, same=False)
    return _cat(b3, b7, _maxpool(x))


def _inception_e(x, w, name, ep, max_pool=False):
    b1 = _conv_bn(x, w, f"{name}.branch1x1")
    b3 = _conv_bn(x, w, f"{name}.branch3x3_1")
    b3 = _cat(_conv_bn(b3, w, f"{name}.branch3x3_2a"), _conv_bn(b3, w, f"{name}.branch3x3_2b"))
    bd = _conv_bn(_conv_bn(x, w, f"{name}.branch3x3dbl_1"), w, f"{name}.branch3x3dbl_2")
    bd = _cat(_conv_bn(bd, w, f"{name}.branch3x3dbl_3a"),
              _conv_bn(bd, w, f"{name}.branch3x3dbl_3b"))
    # pytorch-fid's FIDInceptionE_2 (Mixed_7c) takes a MAX branch pool
    pooled = F.max_pool2d(x, 3, 1, 1) if max_pool else _avgpool3(x, ep)
    return _cat(b1, b3, bd, _conv_bn(pooled, w, f"{name}.branch_pool"))


def detect_variant(w: Dict) -> str:
    """'fid' for pt_inception checkpoints (1008-class fc), else 'torchvision'."""
    return "fid" if tuple(np.shape(w["fc.weight"]))[0] == 1008 else "torchvision"


def to_device(w: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The weight dict as fp32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32)).to(device) for k, v in w.items()}


def inception_v3_forward(x: torch.Tensor, w: Dict[str, torch.Tensor],
                         variant: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) in [0, 1] -> (pool3 features (B, 2048), logits (B, N)),
    on x's device with `w` from to_device there; `variant` as
    detect_variant when None."""
    variant = variant or detect_variant(w)
    ep = variant == "fid"  # exclude-pad average pools
    with exact_fp32():
        x = x.float()
        if x.shape[1] != 299 or x.shape[2] != 299:
            x = resize_bilinear(x, 299)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        if ep:  # pytorch-fid normalize_input: [0, 1] -> [-1, 1]
            x = x * 2.0 - 1.0
        else:   # torchvision's eval transform
            x = ((x - torch.tensor(_IMAGENET_MEAN, device=x.device))
                 / torch.tensor(_IMAGENET_STD, device=x.device))
        x = x.permute(0, 3, 1, 2)
        x = _conv_bn(x, w, "Conv2d_1a_3x3", stride=2, same=False)
        x = _conv_bn(x, w, "Conv2d_2a_3x3", same=False)
        x = _maxpool(_conv_bn(x, w, "Conv2d_2b_3x3"))
        x = _conv_bn(x, w, "Conv2d_3b_1x1")
        x = _maxpool(_conv_bn(x, w, "Conv2d_4a_3x3", same=False))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(x, w, name, ep)
        x = _inception_b(x, w, "Mixed_6a")
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(x, w, name, ep)
        x = _inception_d(x, w, "Mixed_7a")
        x = _inception_e(x, w, "Mixed_7b", ep)
        x = _inception_e(x, w, "Mixed_7c", ep, max_pool=ep)
        feats = x.mean(dim=(2, 3))  # adaptive average pool -> (B, 2048)
        return feats, feats @ w["fc.weight"].t() + w["fc.bias"]


def conv_specs():
    """(name, out, in, kh, kw) of every BasicConv2d of torchvision's
    inception_v3 (the aux head left out): the published weights' shapes."""
    specs = [("Conv2d_1a_3x3", 32, 3, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
             ("Conv2d_2b_3x3", 64, 32, 3, 3), ("Conv2d_3b_1x1", 80, 64, 1, 1),
             ("Conv2d_4a_3x3", 192, 80, 3, 3)]
    for name, cin, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)):
        specs += [(f"{name}.branch1x1", 64, cin, 1, 1), (f"{name}.branch5x5_1", 48, cin, 1, 1),
                  (f"{name}.branch5x5_2", 64, 48, 5, 5), (f"{name}.branch3x3dbl_1", 64, cin, 1, 1),
                  (f"{name}.branch3x3dbl_2", 96, 64, 3, 3),
                  (f"{name}.branch3x3dbl_3", 96, 96, 3, 3), (f"{name}.branch_pool", pool, cin, 1, 1)]
    specs += [("Mixed_6a.branch3x3", 384, 288, 3, 3), ("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1),
              ("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3), ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)]
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        specs += [(f"{name}.branch1x1", 192, 768, 1, 1), (f"{name}.branch7x7_1", c7, 768, 1, 1),
                  (f"{name}.branch7x7_2", c7, c7, 1, 7), (f"{name}.branch7x7_3", 192, c7, 7, 1),
                  (f"{name}.branch7x7dbl_1", c7, 768, 1, 1),
                  (f"{name}.branch7x7dbl_2", c7, c7, 7, 1),
                  (f"{name}.branch7x7dbl_3", c7, c7, 1, 7),
                  (f"{name}.branch7x7dbl_4", c7, c7, 7, 1),
                  (f"{name}.branch7x7dbl_5", 192, c7, 1, 7),
                  (f"{name}.branch_pool", 192, 768, 1, 1)]
    specs += [("Mixed_7a.branch3x3_1", 192, 768, 1, 1), ("Mixed_7a.branch3x3_2", 320, 192, 3, 3),
              ("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1),
              ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
              ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
              ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)]
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        specs += [(f"{name}.branch1x1", 320, cin, 1, 1), (f"{name}.branch3x3_1", 384, cin, 1, 1),
                  (f"{name}.branch3x3_2a", 384, 384, 1, 3),
                  (f"{name}.branch3x3_2b", 384, 384, 3, 1),
                  (f"{name}.branch3x3dbl_1", 448, cin, 1, 1),
                  (f"{name}.branch3x3dbl_2", 384, 448, 3, 3),
                  (f"{name}.branch3x3dbl_3a", 384, 384, 1, 3),
                  (f"{name}.branch3x3dbl_3b", 384, 384, 3, 1),
                  (f"{name}.branch_pool", 192, cin, 1, 1)]
    return specs


def random_weights(rng: np.random.Generator, n_classes: int = 1000) -> Dict[str, np.ndarray]:
    """Seeded random weights at the published shapes (convolutions N(0,
    0.05), identity batch norms, fc N(0, 0.01)): for running the graph
    where no published file is at hand; its features mean nothing."""
    w = {}
    for name, o, i, kh, kw in conv_specs():
        w[f"{name}.conv.weight"] = (rng.standard_normal((o, i, kh, kw)) * 0.05).astype(np.float32)
        w[f"{name}.bn.weight"] = np.ones(o, np.float32)
        w[f"{name}.bn.bias"] = np.zeros(o, np.float32)
        w[f"{name}.bn.running_mean"] = np.zeros(o, np.float32)
        w[f"{name}.bn.running_var"] = np.ones(o, np.float32)
    w["fc.weight"] = (rng.standard_normal((n_classes, 2048)) * 0.01).astype(np.float32)
    w["fc.bias"] = np.zeros(n_classes, np.float32)
    return w


def make_inception_fns(weights: Dict[str, np.ndarray], batch: int = 32, device="cuda"):
    """(feature_fn, probs_fn, run) over host numpy images, batched on
    `device`: features (N, 2048), softmax class probabilities (N, classes),
    and `run` giving both from one forward (FID and the Inception score
    share it)."""
    from egom2p_torch.core.device import resolve_device
    device = resolve_device(device)
    variant = detect_variant(weights)
    w = to_device(weights, device)

    @torch.no_grad()
    def run(images):
        fs, ps = [], []
        for i in range(0, len(images), batch):
            x = torch.as_tensor(np.asarray(images[i:i + batch], dtype=np.float32)).to(device)
            f, logits = inception_v3_forward(x, w, variant)
            fs.append(f.cpu().numpy())
            ps.append(torch.softmax(logits, dim=-1).cpu().numpy())
        return np.concatenate(fs), np.concatenate(ps)

    return (lambda imgs: run(imgs)[0]), (lambda imgs: run(imgs)[1]), run


def convert_inception_pth(path: str, out_path: str) -> str:
    """A local torchvision inception_v3 checkpoint (.pth state dict) -> the
    flat .npz this module loads (the aux classifier and the batch counters
    dropped; conv kernels kept in torch's (O, I, kh, kw) layout)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = sd.get("state_dict", sd.get("model", sd))
    np.savez(out_path, **{k: v.detach().numpy() for k, v in sd.items()
                          if not k.startswith("AuxLogits") and "num_batches" not in k})
    return out_path
