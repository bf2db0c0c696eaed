"""The fused CE backward of the PyTorch port against the JAX package.

With EGOM2P_CE_PALLAS_BWD=1 both packages send the backward of
flash_ce_total to the fused kernel: the JAX side runs its Pallas
`_ce_bwd_kernel` in interpret mode, the port calls `ce_bwd`, whose plain
version (the chunked recompute with fp32 dy) serves CPU tensors.  Inputs
come from numpy with a fixed seed, with zero-weight rows and vocabularies
that the JAX kernel's tile does not divide (padded vocab rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.ops.flash_ce as jax_fce
import egom2p_torch.ops.flash_ce as fce

torch.set_num_threads(2)

# fp32 operands: the same dl in both, dy and dW summed in fp32 in another
# order (measured max 9.8e-7 of each gradient's max)
GRAD_TOL = 5e-6
# bf16 y: dl is rounded to bf16 in both and dy leaves in bf16, so a few
# roundings flip by one bf16 ulp (measured 9.0e-6 of dy's max; dW 1.6e-6)
BF16_DY_TOL = 1e-4
TOTAL_RTOL = 1e-6


def _inputs(rng, R, D, V):
    y = rng.standard_normal((R, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    t = rng.integers(0, V, R).astype(np.int32)
    wts = (rng.uniform(size=R) > 0.3).astype(np.float32)  # zero-weight rows
    return y, w, t, wts


def _jax_grads(monkeypatch, y, w, t, wts):
    monkeypatch.setenv("EGOM2P_CE_PALLAS_BWD", "1")

    def total(a, b):
        return jax_fce.flash_ce_total(a, b, jnp.asarray(t), jnp.asarray(wts), interpret=True)

    val, (dy, dw) = jax.value_and_grad(total, argnums=(0, 1))(y, w)
    return float(val), np.asarray(dy.astype(jnp.float32)), np.asarray(dw)


def _port_grads(monkeypatch, y, w, t, wts):
    monkeypatch.setenv("EGOM2P_CE_PALLAS_BWD", "1")
    y, w = y.requires_grad_(), w.requires_grad_()
    total = fce.flash_ce_total(y, w, torch.from_numpy(t), torch.from_numpy(wts))
    total.backward()
    return total.item(), y.grad, w.grad


@pytest.mark.parametrize("R,D,V", [(200, 128, 5000), (130, 256, 4096), (64, 384, 700)])
def test_ce_bwd_plain_matches_jax_fused_kernel(monkeypatch, R, D, V):
    y, w, t, wts = _inputs(np.random.default_rng(0), R, D, V)
    total, dy, dw = _port_grads(monkeypatch, torch.from_numpy(y), torch.from_numpy(w), t, wts)
    j_total, j_dy, j_dw = _jax_grads(monkeypatch, jnp.asarray(y), jnp.asarray(w), t, wts)
    np.testing.assert_allclose(total, j_total, rtol=TOTAL_RTOL)
    assert dy.dtype == dw.dtype == torch.float32
    for name, g, r in (("dy", dy.numpy(), j_dy), ("dW", dw.numpy(), j_dw)):
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max(), name
    assert torch.count_nonzero(dy[torch.from_numpy(wts) == 0]) == 0  # zero-weight rows


def test_ce_bwd_bf16_operands_match_jax(monkeypatch):
    """bf16 y (the training dtype): W is cast to bf16 for the products, dl
    is rounded to bf16, dy comes back in bf16 and dW in W's dtype."""
    y, w, t, wts = _inputs(np.random.default_rng(1), 128, 128, 4100)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    total, dy, dw = _port_grads(monkeypatch, yb, torch.from_numpy(w), t, wts)
    assert dy.dtype == torch.bfloat16 and dw.dtype == torch.float32
    j_total, j_dy, j_dw = _jax_grads(monkeypatch, jnp.asarray(y, jnp.bfloat16),
                                     jnp.asarray(w), t, wts)
    np.testing.assert_allclose(total, j_total, rtol=TOTAL_RTOL)
    assert np.abs(dy.float().numpy() - j_dy).max() <= BF16_DY_TOL * np.abs(j_dy).max()
    assert np.abs(dw.numpy() - j_dw).max() <= GRAD_TOL * np.abs(j_dw).max()


def test_ce_bwd_switch_routes_the_backward(monkeypatch):
    """EGOM2P_CE_PALLAS_BWD=1, read when the backward runs, sends it to
    `ce_bwd`; unset, to the chunked backward.  Both give the same dW and,
    up to dy's rounding to y's dtype, the same dy."""
    calls = []
    for name in ("ce_bwd", "_bwd_chunked"):
        real = getattr(fce, name)
        monkeypatch.setattr(fce, name, lambda *a, _real=real, _name=name, **kw:
                            calls.append(_name) or _real(*a, **kw))
    y, w, t, wts = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(2), 96, 128, 600))
    grads = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("EGOM2P_CE_PALLAS_BWD", switch)
        yr, wr = y.clone().requires_grad_(), w.clone().requires_grad_()
        fce.flash_ce_total(yr, wr, t, wts, chunk=32).backward()
        grads[switch] = (yr.grad, wr.grad)
    assert calls[0] == "_bwd_chunked" and calls[1] == "ce_bwd"
    for fused, chunked in zip(grads["1"], grads["0"]):  # fp32 sums over other chunks
        assert (fused - chunked).abs().max() <= GRAD_TOL * chunked.abs().max()


def test_ce_bwd_wrapper_is_the_plain_version_on_the_cpu():
    """ce_bwd on CPU tensors runs ce_bwd_reference and counts no launch;
    the result does not depend on the plain version's chunk."""
    y, w, t, wts = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(3), 100, 128, 300))
    logz, _ = fce.row_stats_reference(y, w, t)
    before = fce.ce_bwd.launches
    dy, dw = fce.ce_bwd(y, w, t, wts * 0.5, logz)
    assert fce.ce_bwd.launches == before
    rdy, rdw = fce.ce_bwd_reference(y, w, t, wts * 0.5, logz, chunk=7)
    torch.testing.assert_close(dy, rdy, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-7)
    # against autograd through the dense logits
    yr, wr = y.clone().requires_grad_(), w.clone().requires_grad_()
    logits = yr @ wr.t()
    (0.5 * wts * (torch.logsumexp(logits, -1) - logits.gather(1, t.long()[:, None])[:, 0])
     ).sum().backward()
    torch.testing.assert_close(dy, yr.grad, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dw, wr.grad, rtol=1e-4, atol=1e-6)


def test_ce_bwd_rejects_bad_arguments():
    y = torch.zeros((4, 128))
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):  # D not a multiple of 128
        fce.ce_bwd(y[:, :96], torch.zeros((10, 96)), t, torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError):  # targets of another length
        fce.ce_bwd(y, torch.zeros((10, 128)), t[:3], torch.ones(3), torch.zeros(3))
    with pytest.raises(RuntimeError):
        fce.ce_bwd(y.to("meta"), torch.zeros((10, 128), device="meta"),
                   t.to("meta"), torch.ones(4, device="meta"), torch.zeros(4, device="meta"))
