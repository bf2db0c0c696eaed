"""The fused attention backward of the PyTorch port against the JAX package.

With EGOM2P_F64T_FUSED_BWD=1 both packages send the backward of
flash64_train_attention to the one-pass fused kernel: the JAX side runs its
Pallas `_dqkv_kernel` in interpret mode under `jax.vjp`, the port's
autograd function runs `flash64_train_dqkv`, whose plain version serves CPU
tensors.  Inputs come from numpy with a fixed seed.  Mask modes none, key
padding and segments; both softmax forms; ragged N and M; fully blocked
rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.ops.flash64_train as jax_f64t
import egom2p_torch.ops.flash64_train as ft

torch.set_num_threads(2)

# o is bf16 in both from the same math summed in another order: a bf16 ulp
# of |o| < 0.5 (both backward routes share the forward)
O_ATOL = 5e-3
# dq stays fp32 in both fused kernels; dk and dv are bf16; p and dS are
# rounded to bf16 inside, so an fp32 difference in the order of sums flips
# a few roundings by one ulp (measured max 1.9e-3 of each gradient's max;
# o within 2.0e-3)
GRAD_TOL = 1e-2


def _inputs(rng, B, N, M, H, mode):
    C = H * 64
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, N, C), (B, M, C), (B, M, C), (B, N, C)))
    kvb = seg = None
    if mode == "kp":
        kvb = rng.uniform(size=(B, M)) < 0.3
        kvb[-1] = True  # a fully blocked batch row
    elif mode == "seg":
        # the decoder's layout: modality blocks, then masked positions (-1)
        seg = np.sort(rng.integers(0, 5, (B, N)), axis=1)
        seg = np.array([5, 9, 11, 13, -1], np.int32)[seg]
    return q, k, v, do, kvb, seg


def _jax_fused(monkeypatch, q, k, v, do, kvb, seg, safemax):
    """(o, dq, dk, dv) of the JAX package with its fused backward kernel."""
    monkeypatch.setenv("EGOM2P_F64T_FUSED_BWD", "1")
    kvb_j = None if kvb is None else jnp.asarray(kvb)
    seg_j = None if seg is None else jnp.asarray(seg)
    o, vjp = jax.vjp(lambda a, b, c: jax_f64t.flash64_train_attention(
        a, b, c, kvb_j, seg_j, interpret=True, safemax=safemax),
        *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(monkeypatch, q, k, v, do, kvb, seg, safemax):
    monkeypatch.setenv("EGOM2P_F64T_FUSED_BWD", "1")
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = ft.flash64_train_attention(qt, kt, vt, None if kvb is None else torch.from_numpy(kvb),
                                   None if seg is None else torch.from_numpy(seg),
                                   safemax=safemax)
    o.backward(torch.from_numpy(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("mode,N,M", [
    ("none", 200, 300),    # ragged q and kv edges, cross-attention shape
    ("kp", 256, 384),
    ("kp", 300, 200),
    ("seg", 256, 256),
    ("seg", 300, 300),     # ragged: queries and keys past N match nothing
])
def test_fused_bwd_plain_matches_jax_fused_kernel(monkeypatch, safemax, mode, N, M):
    inputs = _inputs(np.random.default_rng(0), 2, N, M, 2, mode)
    got = _port(monkeypatch, *inputs, safemax)
    ref = _jax_fused(monkeypatch, *inputs, safemax)
    np.testing.assert_allclose(got[0], ref[0], atol=O_ATOL, rtol=0, err_msg="o")
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max(), name
    kvb = inputs[4]
    if kvb is not None:  # the fully blocked batch row: exact zeros
        for name, g in zip(("o", "dq", "dk", "dv"), got):
            assert not np.any(g[kvb.all(axis=1)]), name


def test_fused_switch_routes_the_backward(monkeypatch):
    """EGOM2P_F64T_FUSED_BWD=1, read when the backward runs, sends it to the
    one fused wrapper; unset, to the dq and dk/dv wrappers."""
    calls = []
    for name in ("flash64_train_dq", "flash64_train_dkv", "flash64_train_dqkv"):
        real = getattr(ft, name)
        monkeypatch.setattr(ft, name, lambda *a, _real=real, _name=name, **kw:
                            calls.append(_name) or _real(*a, **kw))
    q, k, v, do, kvb, _ = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(np.random.default_rng(1), 2, 128, 128, 2, "kp"))
    grads = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("EGOM2P_F64T_FUSED_BWD", fused)
        qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
        ft.flash64_train_attention(qt, kt, vt, kvb).backward(do)
        grads[fused] = (qt.grad, kt.grad, vt.grad)
    assert calls == ["flash64_train_dq", "flash64_train_dkv", "flash64_train_dqkv"]
    # dk and dv are the same math; dq differs by the split kernel's bf16 rounding
    assert torch.equal(grads["0"][1], grads["1"][1])
    assert torch.equal(grads["0"][2], grads["1"][2])
    dq_split, dq_fused = grads["0"][0], grads["1"][0]
    assert torch.equal(dq_fused.to(torch.bfloat16).float(), dq_split)
    assert not torch.equal(dq_fused, dq_split)


def test_fused_wrapper_is_the_plain_version_on_the_cpu():
    """flash64_train_dqkv on CPU tensors runs its plain version and counts no
    launch; the plain version is the split plain versions' math with dq
    left in fp32."""
    q, k, v, do, _, seg = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(np.random.default_rng(2), 2, 160, 160, 2, "seg"))
    o, l2 = ft.flash64_train_fwd(q, k, v, segments=seg)
    d = ft.row_dot(do, o)
    before = ft.flash64_train_dqkv.launches
    dq, dk, dv = ft.flash64_train_dqkv(q, k, v, do, l2, d, None, seg)
    assert ft.flash64_train_dqkv.launches == before
    ref = ft.flash64_train_reference_dqkv(q, k, v, do, l2, d, None, seg)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want)
    split_dq = ft.flash64_train_reference_dq(q, k, v, do, l2, d, None, seg)
    assert torch.equal(dq.to(torch.bfloat16).float(), split_dq)
    assert torch.equal(dk, ft.flash64_train_reference_dkv(q, k, v, do, l2, d, None, seg)[0])


def test_fused_kernel_needs_the_card():
    """The launcher refuses CPU tensors: the kernel runs on CUDA only."""
    q = torch.zeros((1, 64, 128), dtype=torch.bfloat16)
    l2 = torch.zeros((1, 2, 64))
    with pytest.raises(RuntimeError):
        ft.launch("dqkv", q, q, q, None, None, False, q, l2, l2)
