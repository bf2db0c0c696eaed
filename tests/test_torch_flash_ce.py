"""flash_ce in the PyTorch port against the JAX package's Pallas kernel.

On the CPU the port's `row_stats` runs its plain version; the JAX side runs
`_row_stats` (the Pallas forward kernel) in interpret mode, and `jax.grad`
of `flash_ce_total` for the backward (the chunked recompute).  Inputs come
from numpy with a fixed seed, with zero-weight rows and vocabularies that
the JAX kernel's tile does not divide.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.ops.flash_ce as jax_fce
from egom2p_torch.ops.flash_ce import (flash_ce_total, matmul_f32, row_stats,
                                       row_stats_reference)

torch.set_num_threads(2)

# fp32 logits summed in another order; logsumexp in two forms (measured max
# 1.2e-7 relative on logz; gold equal)
STATS_RTOL = 1e-6
# the total is a sum of R such terms (measured max 1.0e-7 relative)
TOTAL_RTOL = 1e-6
# dy, dW from the same chunked recompute in fp32 (measured max 7.3e-7 of
# each tensor's max |ref|)
GRAD_TOL = 5e-6


def _inputs(rng, R, D, V, dtype=np.float32):
    y = rng.standard_normal((R, D)).astype(dtype)
    w = (rng.standard_normal((V, D)) * 0.05).astype(dtype)
    t = rng.integers(0, V, R).astype(np.int32)
    wts = (rng.uniform(size=R) > 0.3).astype(np.float32)  # zero-weight rows
    return y, w, t, wts


@pytest.mark.parametrize("R,D,V", [(200, 128, 5000), (300, 256, 4096), (64, 384, 640)])
def test_row_stats_plain_matches_jax_kernel(R, D, V):
    y, w, t, _ = _inputs(np.random.default_rng(0), R, D, V)
    logz, gold = row_stats(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t))
    j_logz, j_gold = jax_fce._row_stats(jnp.asarray(y), jnp.asarray(w), jnp.asarray(t),
                                        interpret=True)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), rtol=STATS_RTOL)
    np.testing.assert_allclose(gold.numpy(), np.asarray(j_gold), rtol=STATS_RTOL,
                               atol=STATS_RTOL)


@pytest.mark.parametrize("chunk", [64, 2048])
def test_flash_ce_total_and_grads_match_jax(chunk):
    R, D, V = 200, 128, 5000
    y, w, t, wts = _inputs(np.random.default_rng(1), R, D, V)
    yt, wt = torch.from_numpy(y).requires_grad_(), torch.from_numpy(w).requires_grad_()
    total = flash_ce_total(yt, wt, torch.from_numpy(t), torch.from_numpy(wts), chunk=chunk)
    total.backward()

    def jtotal(a, b):
        return jax_fce.flash_ce_total(a, b, jnp.asarray(t), jnp.asarray(wts), chunk=chunk,
                                      interpret=True)

    j_total, (j_dy, j_dw) = jax.value_and_grad(jtotal, argnums=(0, 1))(jnp.asarray(y),
                                                                      jnp.asarray(w))
    np.testing.assert_allclose(total.item(), float(j_total), rtol=TOTAL_RTOL)
    for name, g, r in (("dy", yt.grad, j_dy), ("dW", wt.grad, j_dw)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), name
    # zero-weight rows get no gradient
    assert torch.count_nonzero(yt.grad[torch.from_numpy(wts) == 0]) == 0


def test_flash_ce_bf16_operands_match_jax():
    """bf16 y (the training dtype): W is cast to bf16 for the products,
    logits stay fp32, dy comes back in bf16 and dW in W's dtype."""
    R, D, V = 128, 128, 4096
    y, w, t, wts = _inputs(np.random.default_rng(2), R, D, V)
    yb = torch.from_numpy(y).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    total = flash_ce_total(yb, wt, torch.from_numpy(t), torch.from_numpy(wts))
    total.backward()
    assert yb.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32

    def jtotal(a, b):
        return jax_fce.flash_ce_total(a, b, jnp.asarray(t), jnp.asarray(wts), interpret=True)

    j_total, (j_dy, j_dw) = jax.value_and_grad(jtotal, argnums=(0, 1))(
        jnp.asarray(y, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(total.item(), float(j_total), rtol=TOTAL_RTOL)
    # dy is rounded to bf16 in both (measured equal); dW sums bf16-rounded
    # dl in fp32 (measured 1.3e-6 of its max)
    dy_ref = np.asarray(j_dy.astype(jnp.float32))
    assert np.abs(yb.grad.float().numpy() - dy_ref).max() <= GRAD_TOL * np.abs(dy_ref).max()
    dw_ref = np.asarray(j_dw)
    assert np.abs(wt.grad.numpy() - dw_ref).max() <= GRAD_TOL * np.abs(dw_ref).max()


def test_row_stats_live_rows():
    """`live`: a dead row's logz is +inf and its gold 0; a live row's values
    do not depend on the others (chunks cut across the dead runs)."""
    y, w, t, _ = _inputs(np.random.default_rng(4), 300, 128, 700)
    args = (torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t))
    pos = torch.arange(300)
    live = (pos < 40) | ((pos >= 170) & (pos < 171)) | (pos >= 260)
    logz, gold = row_stats(*args, live=live)
    assert torch.all(logz[~live] == float("inf")) and torch.all(gold[~live] == 0)
    whole = row_stats_reference(*args, chunk=64)
    assert torch.equal(logz[live], whole[0][live]) and torch.equal(gold[live], whole[1][live])
    dead = row_stats_reference(*args, chunk=7, live=torch.zeros(300, dtype=torch.bool))
    assert torch.all(dead[0] == float("inf")) and torch.all(dead[1] == 0)
    with pytest.raises(ValueError):
        row_stats(*args, live=live[:-1])


@pytest.mark.parametrize("pattern", ["dead runs", "all dead", "one live row"])
def test_flash_ce_total_with_dead_rows_matches_jax(pattern):
    """flash_ce_total where runs of rows weigh 0, as the decoder lays out the
    other modalities' rows (the port computes no logz for them), against
    the JAX package's flash_ce_total: total, dy and dW."""
    R, D, V = 300, 128, 700
    y, w, t, _ = _inputs(np.random.default_rng(5), R, D, V)
    pos = np.arange(R)
    wts = {"dead runs": ((pos // 100) % 2 == 0) * 0.5 + (pos == 150) * 2.0,
           "all dead": np.zeros(R), "one live row": (pos == 233) * 1.0}[pattern]
    wts = wts.astype(np.float32)
    yt, wt = torch.from_numpy(y).requires_grad_(), torch.from_numpy(w).requires_grad_()
    total = flash_ce_total(yt, wt, torch.from_numpy(t), torch.from_numpy(wts), chunk=64)
    total.backward()

    def jtotal(a, b):
        return jax_fce.flash_ce_total(a, b, jnp.asarray(t), jnp.asarray(wts), chunk=64,
                                      interpret=True)

    j_total, (j_dy, j_dw) = jax.value_and_grad(jtotal, argnums=(0, 1))(jnp.asarray(y),
                                                                      jnp.asarray(w))
    assert np.isfinite(total.item())
    np.testing.assert_allclose(total.item(), float(j_total), rtol=TOTAL_RTOL, atol=0)
    for name, g, r in (("dy", yt.grad, j_dy), ("dW", wt.grad, j_dw)):
        r = np.asarray(r)
        assert torch.isfinite(g).all(), name
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), name
    assert torch.count_nonzero(yt.grad[torch.from_numpy(wts) == 0]) == 0


def test_row_stats_reference_chunks_and_counts():
    """Chunking does not change the result, and CPU calls count no launch."""
    y, w, t, _ = _inputs(np.random.default_rng(3), 100, 128, 300)
    args = (torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t))
    before = row_stats.launches
    whole = row_stats_reference(*args, chunk=4096)
    parts = row_stats_reference(*args, chunk=7)
    torch.testing.assert_close(whole, parts, rtol=1e-6, atol=1e-6)
    assert torch.equal(row_stats(*args)[0], whole[0])
    assert row_stats.launches == before
    logits = args[0] @ args[1].t()
    torch.testing.assert_close(whole[0], torch.logsumexp(logits, -1))
    torch.testing.assert_close(whole[1], logits.gather(1, args[2].long()[:, None])[:, 0])


def test_matmul_f32_of_bf16_operands():
    a = torch.randn(8, 128).to(torch.bfloat16)
    b = torch.randn(128, 16).to(torch.bfloat16)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.float() @ b.float())


def test_flash_ce_rejects_bad_arguments():
    y = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        row_stats(y[:, :96], torch.zeros((10, 96)), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        row_stats(y, torch.zeros((10, 64)), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        row_stats(y, torch.zeros((10, 128)), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(RuntimeError):
        row_stats(y.to("meta"), torch.zeros((10, 128), device="meta"),
                  torch.zeros(4, dtype=torch.int32, device="meta"))
