"""flash64_train in the PyTorch port against the JAX package's Pallas kernels.

On the CPU the port's autograd function runs its plain versions
(`flash64_train_reference_fwd` / `_bwd`); the JAX side runs the real
training kernels (forward, dq, dk/dv) in interpret mode under `jax.vjp`.
Inputs come from numpy with a fixed seed.  Mask modes none, key padding and
segments; both softmax forms; ragged N and M; fully blocked rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.ops.flash64_train as jax_f64t
from egom2p_torch.ops.attention import SegmentMask, masked_attention
from egom2p_torch.ops.flash64_train import (flash64_train_attention,
                                            flash64_train_dkv, flash64_train_dq,
                                            flash64_train_fwd,
                                            flash64_train_reference_bwd,
                                            flash64_train_reference_fwd, row_dot)

torch.set_num_threads(2)

# o is bf16 in both, from the same math summed in another order: a bf16 ulp
# of |o| < 0.5 (measured max 2.0e-3)
O_ATOL = 5e-3
# L2 = log2 of fp32 row sums (measured max 1.7e-7 relative)
L2_RTOL = 1e-6
# gradients are bf16, and p and dS are rounded to bf16 inside: an fp32
# difference in the order of sums flips a few roundings by one ulp
# (measured max 3.6e-3 of each tensor's max |ref|)
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


def _jax(q, k, v, do, kvb, seg, safemax):
    """(o, L2 as (B, H, N), dq, dk, dv) of the JAX package's kernels."""
    N, M = q.shape[1], k.shape[1]
    kvb_j = None if kvb is None else jnp.asarray(kvb)
    seg_j = None if seg is None else jnp.asarray(seg)
    bq, bk = (n + (-n % 128) for n in (N, M))  # whole-sequence blocks, as the default
    _, l2 = jax_f64t._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kvb_j,
                          None if seg is None else seg_j.astype(jnp.float32),
                          bq, bk, True, safemax)
    B, H = q.shape[0], q.shape[2] // 64
    l2 = np.asarray(l2).reshape(B, H, -1)[..., :N]
    o, vjp = jax.vjp(lambda a, b, c: jax_f64t.flash64_train_attention(
        a, b, c, kvb_j, seg_j, interpret=True, safemax=safemax),
        *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return [np.asarray(o), l2] + [np.asarray(g) for g in grads]


def _torch(q, k, v, do, kvb, seg, safemax):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    kvb_t = None if kvb is None else torch.from_numpy(kvb)
    seg_t = None if seg is None else torch.from_numpy(seg)
    o = flash64_train_attention(qt, kt, vt, kvb_t, seg_t, safemax=safemax)
    o.backward(torch.from_numpy(do))
    _, l2 = flash64_train_reference_fwd(qt.detach(), kt.detach(), vt.detach(), kvb_t,
                                        seg_t, safemax)
    return [o.detach().numpy(), l2.numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


def _assert_close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=O_ATOL, rtol=0, err_msg="o")
    live = ref[1] < 1e29
    np.testing.assert_array_equal(got[1][~live], ref[1][~live])  # dead rows: +1e30
    np.testing.assert_allclose(got[1][live], ref[1][live], rtol=L2_RTOL, atol=0,
                               err_msg="L2")
    for name, g, r in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("mode,N,M", [
    ("none", 256, 256),
    ("none", 200, 300),    # ragged q and kv edges, cross-attention shape
    ("kp", 256, 384),
    ("kp", 300, 200),
    ("seg", 256, 256),
    ("seg", 300, 300),     # ragged: queries and keys past N match nothing
    # both sides of the backward kernels' 128-row blocks and 64-row tiles
    ("none", 129, 127),
    ("kp", 127, 129),
    ("seg", 129, 129),
    ("kp", 65, 191),
])
def test_flash64_train_plain_matches_jax_kernels(safemax, mode, N, M):
    rng = np.random.default_rng(0)
    inputs = _inputs(rng, 2, N, M, 2, mode)
    _assert_close(_torch(*inputs, safemax), _jax(*inputs, safemax))


@pytest.mark.parametrize("safemax", [False, True])
def test_flash64_train_dead_rows_are_exact_zeros(safemax):
    rng = np.random.default_rng(1)
    q, k, v, do, kvb, _ = _inputs(rng, 2, 64, 96, 2, "kp")
    kvb[0] = True
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = flash64_train_attention(qt, kt, vt, torch.from_numpy(kvb), safemax=safemax)
    o.backward(torch.from_numpy(do))
    for t in (o, qt.grad, kt.grad, vt.grad):
        assert torch.count_nonzero(t[0]) == 0
    # a segment of its own in seg mode is never dead: it attends to itself
    seg = torch.zeros((1, 64), dtype=torch.int32)
    o2 = flash64_train_attention(qt[:1], qt[:1], qt[:1], segments=seg, safemax=safemax)
    assert torch.count_nonzero(o2) > 0


def test_flash64_train_matches_dense_autograd():
    """The plain forward and backward equal autograd through the dense
    masked attention on the same bf16-rounded inputs, up to the bf16
    roundings of p, dS and the outputs."""
    rng = np.random.default_rng(2)
    q, k, v, do, _, seg = _inputs(rng, 2, 160, 160, 2, "seg")
    qt, kt, vt = (torch.from_numpy(t).to(torch.bfloat16).float().requires_grad_()
                  for t in (q, k, v))
    seg_t = torch.from_numpy(seg)
    o = flash64_train_attention(qt, kt, vt, segments=seg_t, safemax=True)
    o.backward(torch.from_numpy(do))
    fast = [o.detach(), qt.grad, kt.grad, vt.grad]
    for t in (qt, kt, vt):
        t.grad = None
    split = lambda t: t.unflatten(-1, (2, 64)).transpose(1, 2)  # noqa: E731
    dense = masked_attention(split(qt), split(kt), split(vt), SegmentMask(seg_t))
    dense = dense.transpose(1, 2).flatten(-2)
    dense.backward(torch.from_numpy(do))
    for name, f, d in zip(("o", "dq", "dk", "dv"), fast, [dense.detach(), qt.grad, kt.grad,
                                                          vt.grad]):
        assert (f - d).abs().max() <= GRAD_TOL * d.abs().max(), name


def test_flash64_train_wrappers_agree_with_reference_bwd():
    """The three wrappers the autograd function calls are the plain
    versions on the CPU, and count no launch there."""
    rng = np.random.default_rng(3)
    q, k, v, do, kvb, _ = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(rng, 1, 128, 128, 2, "kp"))
    before = (flash64_train_fwd.launches, flash64_train_dq.launches,
              flash64_train_dkv.launches)
    o, l2 = flash64_train_fwd(q, k, v, kvb)
    d = row_dot(do, o)
    dq = flash64_train_dq(q, k, v, do, l2, d, kvb)
    dk, dv = flash64_train_dkv(q, k, v, do, l2, d, kvb)
    ref = flash64_train_reference_bwd(q, k, v, o, l2, do, kvb)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want)
    assert (flash64_train_fwd.launches, flash64_train_dq.launches,
            flash64_train_dkv.launches) == before


def test_flash64_train_safemax_env(monkeypatch):
    """safemax=None reads EGOM2P_F64T_SAFEMAX (default clamp)."""
    q = torch.zeros((1, 4, 128))
    q[0, 0, 0], q[0, 1, 0] = 30.0, 16.0
    k = q.clone()
    v = torch.zeros((1, 4, 128))
    v[0, :, 1] = torch.arange(4.0)
    clamp = flash64_train_attention(q, k, v)
    monkeypatch.setenv("EGOM2P_F64T_SAFEMAX", "1")
    safe = flash64_train_attention(q, k, v)
    assert not torch.equal(safe, clamp)
    assert torch.equal(safe, flash64_train_attention(q, k, v, safemax=True))
    monkeypatch.setenv("EGOM2P_F64T_SAFEMAX", "0")
    assert torch.equal(flash64_train_attention(q, k, v), clamp)


def test_flash64_train_rejects_bad_arguments():
    q = torch.zeros((1, 8, 128))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        flash64_train_attention(q[..., :64], q[..., :64], q[..., :64])  # odd head count
    with pytest.raises(ValueError):
        flash64_train_attention(q, q, q, torch.zeros((1, 8), dtype=torch.bool), seg)
    with pytest.raises(ValueError):
        flash64_train_attention(q, torch.zeros((1, 9, 128)), torch.zeros((1, 9, 128)),
                                segments=seg)  # seg mode is self-attention only
    with pytest.raises(TypeError):
        flash64_train_attention(q, q, q, segments=seg.float())
    with pytest.raises(RuntimeError):
        flash64_train_attention(*(torch.zeros((1, 8, 128), device="meta") for _ in range(3)))
