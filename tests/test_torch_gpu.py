"""Tests of the port's CUDA kernels against their plain PyTorch versions.

They need an NVIDIA card with nvcc (sm_90a) and skip elsewhere.  This file
imports no JAX, so on the card's machine it runs without the JAX package's
conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from egom2p_torch.ops.flash64 import (flash64_attention,
                                      flash64_attention_reference)

pytestmark = pytest.mark.gpu

# bf16 outputs of the same math summed in another order: about one bf16 ulp
ATOL = RTOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(rng, B, N, M, H, device, fused):
    """q/k/v as views of fused (B, N, 3C) / (B, M, 2C) projections when
    `fused`, else separate contiguous tensors."""
    C = H * 64
    if fused:
        x = torch.from_numpy(rng.standard_normal((B, N, 3 * C), np.float32))
        y = torch.from_numpy(rng.standard_normal((B, M, 2 * C), np.float32))
        x, y = x.to(device, torch.bfloat16), y.to(device, torch.bfloat16)
        return x[..., :C], y[..., :C], y[..., C:]
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32))
                 .to(device, torch.bfloat16)
                 for s in ((B, N, C), (B, M, C), (B, M, C)))


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("N,M,mask_kind,fused", [
    (64, 64, "none", False),
    (1707, 1707, "none", True),      # ragged q and kv edges, strided views
    (1707, 3584, "padding", True),   # cross-attention with key padding
    (256, 256, "all", True),         # every key blocked: exact zeros
    (300, 257, "rows", False),       # some batch rows fully blocked
])
def test_flash64_kernel_matches_plain(cuda, safemax, N, M, mask_kind, fused):
    rng = np.random.default_rng(0)
    B, H = 2, 3
    q, k, v = _qkv(rng, B, N, M, H, cuda, fused)
    blocked = None
    if mask_kind == "padding":
        blocked = torch.from_numpy(np.arange(M)[None] >= np.array([[M - 100], [M // 3]]))
    elif mask_kind == "all":
        blocked = torch.ones((B, M), dtype=torch.bool)
    elif mask_kind == "rows":
        blocked = torch.from_numpy(rng.uniform(size=(B, M)) > 0.5)
        blocked[1] = True
    if blocked is not None:
        blocked = blocked.to(cuda)
    before = flash64_attention.launches
    out = flash64_attention(q, k, v, blocked, safemax=safemax)
    torch.cuda.synchronize()
    assert flash64_attention.launches == before + 1
    ref = flash64_attention_reference(q, k, v, blocked, safemax=safemax)
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, H * 64)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    if blocked is not None:
        dead = blocked.all(dim=1)
        assert (out[dead] == 0).all(), "fully blocked rows must be exact zeros"


def test_flash64_kernel_float32_inputs(cuda):
    """fp32 q/k/v are rounded to bf16 like the JAX contract; the result comes
    back in q's dtype."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 300, 128), np.float32))
               .to(cuda) for _ in range(3))
    out = flash64_attention(q, k, v)
    ref = flash64_attention_reference(q, k, v)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


def test_flash64_kernel_rejects_bad_layout(cuda):
    q = torch.zeros((1, 64, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash64_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                          q)  # non-unit stride inside a row
    with pytest.raises(ValueError):
        flash64_attention(q[:, :, :96], q[:, :, :96], q[:, :, :96])  # hd != 64
