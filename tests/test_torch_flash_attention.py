"""The stock route of the PyTorch port against the JAX package.

`segment_flash_attention` / `padding_flash_attention` (egom2p_torch/ops/
flash_attention.py) take head-major q/k/v of any head_dim up to 80.  The
JAX package sends the same calls to the stock Pallas TPU flash kernel,
which has no interpret mode; on the CPU its `masked_attention` computes
them densely in fp32, and that is the reference here.  On CPU tensors the
port runs its kernels' plain versions (heads zero-padded to 64 or 80, bf16
roundings of p, dS and the outputs).  Inputs come from numpy with a fixed
seed, rounded to bf16 values so that both sides see the same numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_torch.ops.flash64_train as ft
import egom2p_torch.ops.flash_attention as fa
from egom2p_torch.ops.attention import SegmentMask, masked_attention
from egom2p_tpu.ops import attention as jax_attention

torch.set_num_threads(2)

# o: the port rounds p and o to bf16, JAX keeps fp32 (measured max 4.1e-3)
O_ATOL = 1e-2
# gradients, against each one's max: p and dS rounded to bf16, dk and dv
# leave in bf16 (measured max 5.7e-3)
GRAD_TOL = 2e-2


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(rng, B, H, N, M, hd, mode):
    q, k, v, do = (_bf16(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, H, N, hd), (B, H, M, hd), (B, H, M, hd), (B, H, N, hd)))
    kvb = seg = None
    if mode == "kp":
        kvb = rng.uniform(size=(B, M)) < 0.3
        kvb[-1] = True  # a fully blocked batch row
    elif mode == "seg":
        seg = np.sort(rng.integers(0, 5, (B, N)), axis=1)
        seg = np.array([5, 9, 11, 13, -1], np.int32)[seg]
    return q, k, v, do, kvb, seg


def _jax(q, k, v, do, kvb, seg):
    """(o, dq, dk, dv) of egom2p_tpu.ops.attention.masked_attention."""
    if seg is not None:
        mask = jax_attention.SegmentMask(jnp.asarray(seg))
    else:
        mask = None if kvb is None else jnp.asarray(kvb)[:, None, None, :]
    o, vjp = jax.vjp(lambda a, b, c: jax_attention.masked_attention(a, b, c, mask),
                     *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, do, kvb, seg):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    if seg is not None:
        o = fa.segment_flash_attention(qt, kt, vt, torch.from_numpy(seg))
    else:
        o = fa.padding_flash_attention(qt, kt, vt, None if kvb is None else torch.from_numpy(kvb))
    o.backward(torch.from_numpy(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("hd", [64, 68])
@pytest.mark.parametrize("mode,N,M", [
    ("none", 256, 300),    # cross-attention shape, ragged for the 64-row tiles
    ("kp", 300, 256),
    ("kp", 256, 256),
    ("seg", 300, 300),
])
def test_stock_route_matches_jax_masked_attention(hd, mode, N, M):
    inputs = _inputs(np.random.default_rng(0), 2, 3, N, M, hd, mode)
    got, ref = _port(*inputs), _jax(*inputs)
    assert got[0].shape == ref[0].shape == (2, 3, N, hd)
    np.testing.assert_allclose(got[0], ref[0], atol=O_ATOL, rtol=0, err_msg="o")
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max(), name
    kvb = inputs[4]
    if kvb is not None:  # the fully blocked batch row: exact zeros
        dead = kvb.all(axis=1)
        assert not np.any(ref[0][dead])
        for name, g in zip(("o", "dq", "dk", "dv"), got):
            assert not np.any(g[dead]), name


def test_scale_is_the_true_head_dims():
    """Heads of 68 run padded to 80 with the scale 68^-0.5: the route equals
    the dense attention of the unpadded heads, and not with 80^-0.5."""
    q, k, v, _, _, _ = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(np.random.default_rng(1), 1, 2, 256, 256, 68, "none"))
    q = q * 4  # sharper rows, where the scale shows (a power of two: still bf16 values)
    o = fa.padding_flash_attention(q, k, v, None)
    dense = torch.softmax(q @ k.transpose(-1, -2) * 68 ** -0.5, -1) @ v
    assert (o - dense).abs().max() < O_ATOL
    wrong = torch.softmax(q @ k.transpose(-1, -2) * 80 ** -0.5, -1) @ v
    assert (o - wrong).abs().max() > 10 * O_ATOL
    torch.testing.assert_close(o, fa.flash_attention_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("hd,kernel", [(64, 64), (32, 64), (66, 80), (68, 80), (80, 80),
                                       (96, None)])
def test_kernel_head_dim(hd, kernel):
    assert fa.kernel_head_dim(hd) == kernel


def test_masked_attention_routes_as_the_jax_package(monkeypatch):
    """masked_attention sends SegmentMask, key padding and no mask at
    N * M >= 256^2 without softmax1 to the stock route, as the JAX package
    does; softmax1, short sequences, other masks and heads over 80 stay
    dense."""
    calls = []
    for name in ("padding_flash_attention", "segment_flash_attention"):
        monkeypatch.setattr(fa, name, lambda q, *a, _name=name: calls.append(_name) or q)
    x = torch.zeros((1, 2, 256, 68))
    seg = torch.zeros((1, 256), dtype=torch.int32)
    kp = torch.zeros((1, 1, 1, 256), dtype=torch.bool)
    for mask, want in ((None, "padding_flash_attention"), (kp, "padding_flash_attention"),
                       (SegmentMask(seg), "segment_flash_attention")):
        calls.clear()
        masked_attention(x, x, x, mask)
        assert calls == [want]
    calls.clear()
    masked_attention(x, x, x, kp, softmax1=True)
    masked_attention(x[:, :, :128], x[:, :, :128], x[:, :, :128], None)  # 128^2 < 256^2
    masked_attention(x, x, x, torch.zeros((1, 1, 256, 256), dtype=torch.bool))  # not padding
    wide = torch.zeros((1, 2, 256, 96))
    masked_attention(wide, wide, wide, None)  # head_dim 96: no kernel
    assert calls == []


def test_wrappers_are_the_plain_versions_on_the_cpu():
    """The stock route's wrappers run their plain versions on CPU tensors
    and count no launch; the launcher refuses CPU tensors."""
    q, k, v, do, kvb, _ = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(np.random.default_rng(2), 2, 2, 128, 128, 68, "kp"))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.padding_flash_attention(qr, kr, vr, kvb)
    out.backward(do)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == before
    assert torch.equal(out, fa.flash_attention_reference(q, k, v, kvb))
    for g, r in zip((qr.grad, kr.grad, vr.grad),
                    fa.flash_attention_reference_bwd(q, k, v, do, kvb)):
        assert torch.equal(g, r)
    packed = torch.zeros((1, 64, 160), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        ft.launch("fwd", packed, packed, packed, None, None, True, hd=80)


def test_stock_route_rejects_bad_arguments():
    x = torch.zeros((1, 2, 64, 68))
    with pytest.raises(ValueError):  # head_dim 96: no kernel
        fa.padding_flash_attention(*(torch.zeros((1, 2, 64, 96)),) * 3, None)
    with pytest.raises(ValueError):  # k of another head_dim
        fa.padding_flash_attention(x, torch.zeros((1, 2, 64, 64)), x, None)
    with pytest.raises(ValueError):  # projection layout, not head-major
        fa.padding_flash_attention(x[0], x[0], x[0], None)
    with pytest.raises(ValueError):  # segment mode is self-attention only
        fa.segment_flash_attention(x, torch.zeros((1, 2, 32, 68)), torch.zeros((1, 2, 32, 68)),
                                   torch.zeros((1, 64), dtype=torch.int32))
