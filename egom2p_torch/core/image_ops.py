"""Two image helpers the teachers and the image metrics share: the JAX
package's bilinear resize and exact fp32 on the card."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C), bilinear with half-pixel centres,
    antialiased when it shrinks (jax.image.resize(..., "bilinear")'s
    triangle kernel), computed in fp32 and returned in x's dtype."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


@contextlib.contextmanager
def exact_fp32():
    """cuDNN's convolutions and cuBLAS's products in full fp32 inside (the
    JAX package's precision), not on the card's TF32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
