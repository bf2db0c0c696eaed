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


# the forward kernel's 128-row query tiles and 128-key stages: lengths on both
# sides of every tile edge, a single row, and the main paths' ragged lengths
RAGGED_SELF = [1, 63, 64, 65, 127, 128, 129, 1707, 2000]
RAGGED_CROSS = [(1, 129), (129, 1), (63, 2000), (2000, 65), (127, 128), (128, 127), (65, 1707)]


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("mode", ["none", "kp", "seg"])
@pytest.mark.parametrize("n", RAGGED_SELF)
def test_flash64_fwd_kernel_ragged_self(cuda, n, mode, safemax):
    """The forward kernel (training instance: o and L2) on strided views of
    a fused projection, no mask / key padding with a dead batch row /
    segments with -1: dead rows are exact zeros with L2 = +1e30."""
    import egom2p_torch.ops.flash64_train as ft
    rng = np.random.default_rng(n)
    q, k, v, _, kvb, seg = _train_inputs(rng, 2, n, n, 2, mode, cuda)
    before = ft.flash64_train_fwd.launches
    o, l2 = ft.flash64_train_fwd(q, k, v, kvb, seg, safemax)
    torch.cuda.synchronize()
    assert ft.flash64_train_fwd.launches == before + 1
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax)
    torch.testing.assert_close(o.float(), ro.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(l2, rl2, atol=1e-4, rtol=0)
    if kvb is not None:
        dead = kvb.all(dim=1)
        assert dead.any() and (o[dead] == 0).all() and (l2[dead] == 1e30).all()


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("N,M", RAGGED_CROSS)
def test_flash64_fwd_kernel_ragged_cross(cuda, N, M, safemax):
    """The inference instance with N != M, key padding on k/v views of a
    fused kv projection, one batch row fully blocked."""
    rng = np.random.default_rng(N * 10000 + M)
    q, k, v = _qkv(rng, 2, N, M, 3, cuda, fused=True)
    blocked = torch.from_numpy(rng.uniform(size=(2, M)) < 0.3)
    blocked[1] = True
    blocked = blocked.to(cuda)
    out = flash64_attention(q, k, v, blocked, safemax=safemax)
    torch.cuda.synchronize()
    ref = flash64_attention_reference(q, k, v, blocked, safemax=safemax)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert (out[1] == 0).all(), "fully blocked rows must be exact zeros"


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("M,live", [
    (8704, [(0, 8534)]),                 # the serving encoder: 8534 live keys of 8704
    (512, [(0, 128), (256, 512)]),       # a fully blocked 128-key stage between live ones
    (640, [(300, 310)]),                 # blocked stages first, ten live keys, blocked stages last
])
def test_flash64_fwd_kernel_blocked_stages(cuda, M, live, safemax):
    rng = np.random.default_rng(M)
    q, k, v = _qkv(rng, 1, 300, M, 2, cuda, fused=True)
    blocked = torch.ones((1, M), dtype=torch.bool)
    for lo, hi in live:
        blocked[:, lo:hi] = False
    blocked = blocked.to(cuda)
    out = flash64_attention(q, k, v, blocked, safemax=safemax)
    torch.cuda.synchronize()
    ref = flash64_attention_reference(q, k, v, blocked, safemax=safemax)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ training kernels
def _train_inputs(rng, B, N, M, H, mode, device):
    C = H * 64
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * C), np.float32)).to(device,
                                                                              torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((B, M, 2 * C), np.float32)).to(device,
                                                                            torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, N, C), np.float32)).to(device, torch.bfloat16)
    q = qkv[..., :C]
    k, v = (qkv[..., C:2 * C], qkv[..., 2 * C:]) if mode == "seg" else (kv[..., :C], kv[..., C:])
    kvb = seg = None
    if mode == "kp":
        kvb = torch.from_numpy(rng.uniform(size=(B, M)) < 0.3).to(device)
        kvb[-1] = True  # a fully blocked batch row
    elif mode == "seg":
        block = np.sort(rng.integers(0, 5, (B, N)), axis=1)
        seg = torch.from_numpy(np.array([5, 9, 11, 13, -1], np.int32)[block]).to(device)
    return q, k, v, do, kvb, seg


# the backward kernels' blocks of 128 rows fed by TMA and streamed tiles of 64
# rows: the forward's ragged lengths in the three mask modes (segments are
# self-attention only)
BWD_RAGGED = ([(mode, n, n) for n in RAGGED_SELF for mode in ("none", "kp", "seg")]
              + [(mode, n, m) for n, m in RAGGED_CROSS for mode in ("none", "kp")])
# where a gradient is rounding noise only (one live key: softmax's gradient is
# zero and the plain version leaves 5e-7), the relative tolerance needs a floor
GRAD_ATOL = 1e-5


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("mode,N,M", [("none", 64, 64), ("none", 300, 333), ("kp", 300, 200),
                                      ("kp", 256, 256), ("seg", 300, 300), ("seg", 1024, 1024)]
                         + BWD_RAGGED)
def test_flash64_train_kernels_match_plain(cuda, safemax, mode, N, M):
    """Forward, dq and dk/dv kernels against their plain versions; fully
    blocked rows give exact zeros in the output and every gradient."""
    import egom2p_torch.ops.flash64_train as ft
    rng = np.random.default_rng(0)
    q, k, v, do, kvb, seg = _train_inputs(rng, 2, N, M, 4, mode, cuda)
    before = (ft.flash64_train_fwd.launches, ft.flash64_train_dq.launches,
              ft.flash64_train_dkv.launches)
    o, l2 = ft.flash64_train_fwd(q, k, v, kvb, seg, safemax)
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax)
    d = ft.row_dot(do, ro)
    dq = ft.flash64_train_dq(q, k, v, do, rl2, d, kvb, seg, safemax)
    dk, dv = ft.flash64_train_dkv(q, k, v, do, rl2, d, kvb, seg, safemax)
    torch.cuda.synchronize()
    assert (ft.flash64_train_fwd.launches, ft.flash64_train_dq.launches,
            ft.flash64_train_dkv.launches) == tuple(b + 1 for b in before)
    torch.testing.assert_close(o.float(), ro.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(l2, rl2, atol=1e-4, rtol=0)
    for g, r in zip((dq, dk, dv), ft.flash64_train_reference_bwd(q, k, v, ro, rl2, do, kvb,
                                                                 seg, safemax)):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max() + GRAD_ATOL
    if kvb is not None:
        dead = kvb.all(dim=1)
        for t in (o, dq, dk, dv):
            assert (t[dead] == 0).all(), "fully blocked rows must be exact zeros"
        assert (l2[dead] == 1e30).all()


@pytest.mark.parametrize("mode", ["kp", "seg"])
def test_flash64_train_autograd_on_the_card(cuda, mode):
    """flash64_train_attention's autograd function on CUDA tensors launches
    the three kernels, and its gradients equal the plain versions'."""
    import egom2p_torch.ops.flash64_train as ft
    rng = np.random.default_rng(1)
    q, k, v, do, kvb, seg = _train_inputs(rng, 2, 512, 512, 2, mode, cuda)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    before = (ft.flash64_train_fwd.launches, ft.flash64_train_dq.launches,
              ft.flash64_train_dkv.launches)
    o = ft.flash64_train_attention(qr, kr, vr, kvb, seg)
    o.backward(do)
    torch.cuda.synchronize()
    assert (ft.flash64_train_fwd.launches, ft.flash64_train_dq.launches,
            ft.flash64_train_dkv.launches) == tuple(b + 1 for b in before)
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg)
    ref = ft.flash64_train_reference_bwd(q, k, v, ro, rl2, do, kvb, seg)
    torch.testing.assert_close(o.float(), ro.float(), atol=ATOL, rtol=RTOL)
    for g, r in zip((qr.grad, kr.grad, vr.grad), ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max()
    # the gradient of a sum reaches the backward expanded (stride 0)
    qs = q.detach().clone().requires_grad_()
    ft.flash64_train_attention(qs, k, v, kvb, seg).sum().backward()
    ones = torch.ones_like(do)
    ref_q = ft.flash64_train_reference_bwd(q, k, v, ro, rl2, ones, kvb, seg)[0]
    assert (qs.grad.float() - ref_q.float()).abs().max() <= 1e-2 * ref_q.float().abs().max()


def test_flash64_train_kernels_reject_bad_layouts(cuda):
    import egom2p_torch.ops.flash64_train as ft
    q = torch.zeros((1, 64, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # non-unit stride inside a row
        ft.flash64_train_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError):  # an odd number of heads
        ft.flash64_train_attention(q[..., :64], q[..., :64], q[..., :64])
    l2 = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(ValueError):  # L2 of the wrong shape
        ft.flash64_train_dq(q, q, q, q, l2[:, :1], l2)
    with pytest.raises(ValueError):  # a misaligned row start
        ft.flash64_train_dq(q, q, q, torch.zeros((1, 64, 129), dtype=torch.bfloat16,
                                                 device=cuda)[..., 1:], l2, l2)


def _ce_inputs(cuda, R, D, V, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    y = torch.randn((R, D), device=cuda, generator=gen).to(torch.bfloat16)
    w = (torch.randn((V, D), device=cuda, generator=gen) * 0.02).to(torch.bfloat16)
    t = torch.randint(0, V, (R,), device=cuda, generator=gen, dtype=torch.int32)
    t[-1] = V - 1  # a target in the last real column
    return y, w, t


# the split instance's sizes (R = 1 ... 2048: many vocab slices), the
# step's R = 16384, vocabularies the 256-column tiles do not divide
@pytest.mark.parametrize("R,D,V", [(16384, 768, 64000), (1000, 768, 64007), (77, 384, 200),
                                   (1000, 1024, 64007), (300, 2048, 5000), (129, 896, 700),
                                   (1, 768, 64007), (127, 768, 700), (129, 1024, 64007),
                                   (512, 1024, 64000), (2048, 768, 64000), (2048, 128, 200)])
def test_flash_ce_kernel_matches_plain(cuda, R, D, V):
    from egom2p_torch.ops.flash_ce import row_stats, row_stats_reference
    y, w, t = _ce_inputs(cuda, R, D, V)
    before = row_stats.launches
    logz, gold = row_stats(y, w, t)
    torch.cuda.synchronize()
    assert row_stats.launches == before + 1
    rlogz, rgold = row_stats_reference(y, w, t)
    torch.testing.assert_close(logz, rlogz, rtol=1e-5, atol=0)
    torch.testing.assert_close(gold, rgold, rtol=0, atol=1e-4)


@pytest.mark.parametrize("R,D,V,pattern", [
    (300, 768, 5000, "all dead"), (300, 768, 5000, "all live"),
    (1000, 768, 64007, "dead run across blocks"),  # rows 100 .. 399: blocks 0-3
    (1000, 1024, 700, "one live row"), (16384, 768, 64000, "step")])
def test_flash_ce_kernel_live_rows(cuda, R, D, V, pattern):
    """The `live` contract: live rows as the plain version gives them, dead
    rows exactly +inf / 0, whether their 128-row block is computed or
    skipped."""
    from egom2p_torch.ops.flash_ce import row_stats, row_stats_reference
    y, w, t = _ce_inputs(cuda, R, D, V, seed=3)
    pos = torch.arange(R, device=cuda)
    live = {"all dead": pos < 0, "all live": pos >= 0,
            "dead run across blocks": (pos < 100) | (pos >= 400),
            "one live row": pos == 517,
            "step": ((pos % 2048) >= 300) & ((pos % 2048) < 1324)}[pattern]
    logz, gold = row_stats(y, w, t, live=live)
    torch.cuda.synchronize()
    rlogz, rgold = row_stats_reference(y, w, t, live=live)
    assert torch.all(logz[~live] == float("inf")) and torch.all(gold[~live] == 0)
    torch.testing.assert_close(logz[live], rlogz[live], rtol=1e-5, atol=0)
    torch.testing.assert_close(gold[live], rgold[live], rtol=0, atol=1e-4)
    whole, _ = row_stats(y, w, t)  # a live row's value does not depend on the others
    assert torch.equal(logz[live], whole[live])


@pytest.mark.parametrize("R,D", [(1000, 768), (512, 1024), (2048, 768)])
def test_flash_ce_split_instance_is_deterministic(cuda, R, D):
    """The vocab split folds its slices in a fixed order: equal bits."""
    from egom2p_torch.ops.flash_ce import fwd_splits, row_stats
    y, w, t = _ce_inputs(cuda, R, D, 64007, seed=4)
    assert fwd_splits(R, D, 64007, torch.cuda.get_device_properties(cuda).multi_processor_count) > 1
    first = row_stats(y, w, t)
    for _ in range(2):
        again = row_stats(y, w, t)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("pallas_bwd", ["0", "1"])
def test_flash_ce_total_skips_dead_rows_through_both_backwards(cuda, monkeypatch, pallas_bwd):
    """flash_ce_total with rows of weight 0 (not computed in the forward):
    the same total and gradients as with every row computed, through the
    chunked backward and the kernel backward, all finite."""
    import egom2p_torch.ops.flash_ce as fce
    monkeypatch.setenv("EGOM2P_CE_PALLAS_BWD", pallas_bwd)
    y, w, t = _ce_inputs(cuda, 4096, 768, 64000, seed=5)
    w = w.float()
    wts = ((torch.arange(4096, device=cuda) % 2048) < 700).float() * 0.3
    real = fce.row_stats
    results = []
    for skip in (True, False):
        if not skip:  # every row computed, as before rows could be skipped
            def all_rows(y_, w_, t_, live=None):
                return real(y_, w_, t_)

            all_rows.launches = 0  # `real` counts its launch on the module's row_stats
            monkeypatch.setattr(fce, "row_stats", all_rows)
        yr, wr = y.clone().requires_grad_(), w.clone().requires_grad_()
        total = fce.flash_ce_total(yr, wr, t, wts, chunk=1024)
        total.backward()
        results.append((total, yr.grad, wr.grad))
    (tk, dyk, dwk), (tp, dyp, dwp) = results
    assert all(torch.isfinite(x).all() for x in (tk, dyk, dwk))
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=0)
    assert (dyk.float() - dyp.float()).abs().max() <= 1e-2 * dyp.float().abs().max()
    assert (dwk - dwp).abs().max() <= 1e-3 * dwp.abs().max()
    assert torch.count_nonzero(dyk[wts == 0]) == 0


def test_flash_ce_total_autograd_on_the_card(cuda):
    """flash_ce_total on CUDA launches the kernel in its forward; the total
    and its gradients equal those of the plain row statistics."""
    import egom2p_torch.ops.flash_ce as fce
    gen = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randn((3000, 768), device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn((64000, 768), device=cuda, generator=gen) * 0.02
    t = torch.randint(0, 64000, (3000,), device=cuda, generator=gen)
    wts = (torch.rand(3000, device=cuda, generator=gen) > 0.5).float()
    results = []
    for stats in (fce.row_stats, fce.row_stats_reference):
        yr, wr = y.clone().requires_grad_(), w.clone().requires_grad_()
        real, fce.row_stats = fce.row_stats, stats
        try:
            before = real.launches
            total = fce.flash_ce_total(yr, wr, t, wts, chunk=1024)
            total.backward()
        finally:
            fce.row_stats = real
        results.append((total, yr.grad, wr.grad, real.launches - before))
    (tk, dyk, dwk, nk), (tp, dyp, dwp, np_) = results
    assert (nk, np_) == (1, 0)
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=0)
    assert dyk.dtype == torch.bfloat16 and dwk.dtype == torch.float32
    assert (dyk.float() - dyp.float()).abs().max() <= 1e-2 * dyp.float().abs().max()
    assert (dwk - dwp).abs().max() <= 1e-3 * dwp.abs().max()


def test_flash_ce_kernel_rejects_what_it_cannot_take(cuda):
    from egom2p_torch.ops.flash_ce import row_stats
    t = torch.zeros(4, dtype=torch.int32, device=cuda)
    y = torch.zeros((4, 1000), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # D = 1000: not a multiple of 128 (nor for the JAX kernel)
        row_stats(y, torch.zeros((10, 1000), dtype=torch.bfloat16, device=cuda), t)
    with pytest.raises(TypeError):  # fp32 y: the kernel takes bf16
        row_stats(y[:, :768].float(), torch.zeros((10, 768), device=cuda), t)


# ------------------------------------------------- fused attention backward
@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("mode,N,M", [("none", 300, 333), ("kp", 300, 200), ("kp", 256, 256),
                                      ("seg", 300, 300), ("seg", 1024, 1024)] + BWD_RAGGED)
def test_flash64_train_dqkv_kernel_matches_plain(cuda, safemax, mode, N, M):
    """The fused dq/dk/dv kernel against its plain version; fully blocked
    rows give exact zeros in every gradient; three runs give bitwise equal
    dk and dv (dq's adds happen in L2 in no fixed order)."""
    import egom2p_torch.ops.flash64_train as ft
    rng = np.random.default_rng(2)
    q, k, v, do, kvb, seg = _train_inputs(rng, 2, N, M, 4, mode, cuda)
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax)
    d = ft.row_dot(do, ro)
    before = ft.flash64_train_dqkv.launches
    got = ft.flash64_train_dqkv(q, k, v, do, rl2, d, kvb, seg, safemax)
    torch.cuda.synchronize()
    assert ft.flash64_train_dqkv.launches == before + 1
    ref = ft.flash64_train_reference_dqkv(q, k, v, do, rl2, d, kvb, seg, safemax)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max() + GRAD_ATOL
    if kvb is not None:
        dead = kvb.all(dim=1)
        for t in got:
            assert (t[dead] == 0).all(), "fully blocked rows must be exact zeros"
    for _ in range(2):
        again = ft.flash64_train_dqkv(q, k, v, do, rl2, d, kvb, seg, safemax)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
        assert (again[0].float() - ref[0].float()).abs().max() <= (
            1e-2 * ref[0].float().abs().max() + GRAD_ATOL)


def test_flash64_train_fused_switch_on_the_card(cuda, monkeypatch):
    """EGOM2P_F64T_FUSED_BWD=1 sends the autograd backward to the one fused
    kernel: one dqkv launch, no dq or dk/dv launch."""
    import egom2p_torch.ops.flash64_train as ft
    monkeypatch.setenv("EGOM2P_F64T_FUSED_BWD", "1")
    rng = np.random.default_rng(3)
    q, k, v, do, kvb, seg = _train_inputs(rng, 2, 512, 512, 2, "kp", cuda)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    counts = lambda: (ft.flash64_train_dq.launches, ft.flash64_train_dkv.launches,  # noqa: E731
                      ft.flash64_train_dqkv.launches)
    before = counts()
    ft.flash64_train_attention(qr, kr, vr, kvb, seg).backward(do)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1)
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg)
    ref = ft.flash64_train_reference_dqkv(q, k, v, do, rl2, ft.row_dot(do, ro), kvb, seg)
    for g, r in zip((qr.grad, kr.grad, vr.grad), ref):
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max()


# ----------------------------------------------------------- the stock route
@pytest.mark.parametrize("hd", [64, 68, 66])
@pytest.mark.parametrize("mode,N,M", [("none", 300, 333), ("kp", 300, 200), ("seg", 300, 300),
                                      ("kp", 256, 256)])
def test_stock_route_kernels_match_plain(cuda, hd, mode, N, M):
    """padding/segment_flash_attention on the card (forward and fused
    backward kernels at head_dim 64 or 80) against the plain versions."""
    import egom2p_torch.ops.flash_attention as fa
    rng = np.random.default_rng(4)
    B, H = 2, 3
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda, torch.bfloat16)
                   for s in ((B, H, N, hd), (B, H, M, hd), (B, H, M, hd), (B, H, N, hd)))
    kvb = seg = None
    if mode == "kp":
        kvb = torch.from_numpy(rng.uniform(size=(B, M)) < 0.3).to(cuda)
        kvb[-1] = True  # a fully blocked batch row
    elif mode == "seg":
        seg = torch.from_numpy(np.sort(rng.integers(0, 4, (B, N)), axis=1)).to(cuda)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    out = (fa.segment_flash_attention(qr, kr, vr, seg) if seg is not None
           else fa.padding_flash_attention(qr, kr, vr, kvb))
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_reference(q, k, v, kvb, seg)
    assert out.shape == ref.shape == (B, H, N, hd) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    for g, r in zip((qr.grad, kr.grad, vr.grad),
                    fa.flash_attention_reference_bwd(q, k, v, do, kvb, seg)):
        assert g.shape == r.shape
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max()
    if kvb is not None:
        dead = kvb.all(dim=1)
        for t in (out, qr.grad, kr.grad, vr.grad):
            assert (t[dead] == 0).all(), "fully blocked rows must be exact zeros"


# the width-80 kernels' edges: forward 128-row query tiles and 128-key
# stages; backward 128-key blocks, 32-row query steps, 64-query dQ tiles
WIDE_RAGGED_SELF = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 161, 300)
WIDE_RAGGED_CROSS = ((1, 129), (129, 1), (33, 200), (200, 33), (95, 128), (128, 97))


def _wide_case(rng, B, H, N, M, hd, mode, device):
    """Packed (B, L, H*80) operands of heads of `hd` (zero columns past it),
    as the stock route hands them to the kernels, with no mask, key padding
    (the last batch row fully blocked) or segments with -1."""
    import egom2p_torch.ops.flash_attention as fa
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(device, torch.bfloat16)
                   for s in ((B, H, N, hd), (B, H, M, hd), (B, H, M, hd), (B, H, N, hd)))
    kvb = seg = None
    if mode == "kp":
        kvb = torch.from_numpy(rng.uniform(size=(B, M)) < 0.3).to(device)
        kvb[-1] = True
    elif mode == "seg":
        ids = np.array([31433, 17061, 7210, -1], np.int32)
        seg = torch.from_numpy(ids[np.sort(rng.integers(0, 4, (B, N)), axis=1)]).to(device)
    return tuple(fa._pack(t, 80) for t in (q, k, v, do)) + (kvb, seg)


@pytest.mark.parametrize("mode,N,M", [(mode, n, n) for n in WIDE_RAGGED_SELF
                                      for mode in ("none", "kp", "seg")]
                         + [("kp", n, m) for n, m in WIDE_RAGGED_CROSS])
def test_width80_kernels_ragged(cuda, mode, N, M):
    """The width-80 instances of the forward and the fused backward against
    their plain versions at lengths on both sides of their tiles, heads of
    68 zero-padded to 80: o, L2 and the three gradients; a fully blocked
    batch row gives exact zeros and L2 = 1e30; the padding columns stay
    zero."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa
    rng = np.random.default_rng(N * 1000 + M)
    q, k, v, do, kvb, seg = _wide_case(rng, 2, 3, N, M, 68, mode, cuda)
    kw = dict(hd=80, sm_scale=68 ** -0.5)
    o, l2 = fa.flash_attention_fwd(q, k, v, kvb, seg, **kw)
    torch.cuda.synchronize()
    ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, True, **kw)
    assert (o.float() - ro.float()).abs().max() <= 1e-2
    assert (l2 - rl2).abs().max() <= 1e-4
    args = (q, k, v, do, rl2, ft.row_dot(do, ro, 80), kvb, seg)
    got = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    ref = ft.flash64_train_reference_dqkv(*args, True, **kw)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max() + GRAD_ATOL
    for t in (o,) + tuple(got):
        assert (t.view(*t.shape[:2], 3, 80)[..., 68:] == 0).all(), "padding columns must stay 0"
    if kvb is not None:
        assert (o[1] == 0).all() and (l2[1] == 1e30).all()
        for t in got:
            assert (t[1] == 0).all(), "a fully blocked batch row must give exact zeros"


def test_stock_route_rejects_what_it_cannot_take(cuda):
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa
    q = torch.zeros((1, 2, 64, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # head_dim 96: no kernel
        fa.padding_flash_attention(q, q, q, None)
    x = torch.zeros((1, 64, 160), dtype=torch.bfloat16, device=cuda)
    l2 = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(RuntimeError):  # head_dim 80 exists in the safemax form only
        ft.launch("dqkv", x, x, x, None, None, False, x, l2, l2, hd=80)


# ------------------------------------------------------------ CE backward
@pytest.mark.parametrize("R,D,V", [(2000, 768, 64007), (1000, 768, 64007), (300, 512, 5000),
                                   (77, 256, 200), (640, 256, 1000), (300, 128, 5000),
                                   (300, 384, 5000), (300, 640, 5000), (1000, 1024, 64007),
                                   (300, 2048, 5000), (130, 896, 700)])
def test_flash_ce_bwd_kernel_matches_plain(cuda, R, D, V):
    """The CE backward kernel against the chunked recompute, with about half
    of the rows at weight 0 (in blocks, as training lays them out) and a
    vocab its tiles do not divide; at every column plan: one group with a
    128-column warpgroup (128, 384, 640), and column groups that recompute
    their logits from a streamed owned tile (896, 1024, 2048)."""
    from egom2p_torch.ops.flash_ce import ce_bwd, ce_bwd_reference, row_stats_reference
    gen = torch.Generator(device=cuda).manual_seed(5)
    y = torch.randn((R, D), device=cuda, generator=gen).to(torch.bfloat16)
    w = (torch.randn((V, D), device=cuda, generator=gen) * 0.02).to(torch.bfloat16)
    t = torch.randint(0, V, (R,), device=cuda, generator=gen, dtype=torch.int32)
    wc = ((torch.arange(R, device=cuda) // 100) % 2).float() * 0.37
    logz, _ = row_stats_reference(y, w, t)
    before = ce_bwd.launches
    dy, dw = ce_bwd(y, w, t, wc, logz)
    torch.cuda.synchronize()
    assert ce_bwd.launches == before + 1
    rdy, rdw = ce_bwd_reference(y, w, t, wc, logz)
    assert dy.dtype == dw.dtype == torch.float32
    # dl rounded to bf16 in both; fp32 sums in another order
    assert (dy - rdy).abs().max() <= 1e-3 * rdy.abs().max()
    assert (dw - rdw).abs().max() <= 1e-3 * rdw.abs().max()
    assert torch.count_nonzero(dy[wc == 0]) == 0


@pytest.mark.parametrize("D", [256, 768, 384, 1024])
def test_flash_ce_bwd_kernel_no_live_row(cuda, D):
    """Every row at weight 0: no block has a tile to walk, and both
    gradients are exact zeros."""
    from egom2p_torch.ops.flash_ce import ce_bwd
    gen = torch.Generator(device=cuda).manual_seed(6)
    y = torch.randn((130, D), device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn((300, D), device=cuda, generator=gen).to(torch.bfloat16)
    t = torch.zeros(130, device=cuda, dtype=torch.int32)
    dy, dw = ce_bwd(y, w, t, torch.zeros(130, device=cuda), torch.zeros(130, device=cuda))
    torch.cuda.synchronize()
    assert torch.count_nonzero(dy) == 0 and torch.count_nonzero(dw) == 0


def test_flash_ce_bwd_switch_raises_on_what_it_cannot_take(cuda, monkeypatch):
    """With EGOM2P_CE_PALLAS_BWD=1 a shape or dtype the kernel cannot take
    raises; nothing falls back to the plain backward."""
    import egom2p_torch.ops.flash_ce as fce
    monkeypatch.setenv("EGOM2P_CE_PALLAS_BWD", "1")
    t = torch.zeros(4, dtype=torch.int64, device=cuda)
    wts = torch.ones(4, device=cuda)
    y = torch.randn((4, 1000), device=cuda).to(torch.bfloat16).requires_grad_()
    w = torch.randn((4096, 1000), device=cuda).requires_grad_()
    with pytest.raises(ValueError):  # D = 1000: not a multiple of 128
        fce.flash_ce_total(y, w, t, wts).backward()
    y32 = torch.randn((4, 256), device=cuda).requires_grad_()
    w32 = torch.randn((4096, 256), device=cuda).requires_grad_()
    with pytest.raises(TypeError):  # fp32 operands: the kernel takes bf16
        fce.flash_ce_total(y32, w32, t, wts).backward()


# The Cosmos decoder on the card against the same decoder on CPU tensors, at
# the small topology (channels 16, mults (1, 2, 2), z_channels 8) on the
# full 5 x 32 x 32 token grid: exact fp32 on both sides is the same math in
# another order (cuDNN vs oneDNN); TF32 on the card rounds every product's
# inputs to 10 mantissa bits
SMALL_COSMOS = dict(channels=16, channels_mult=(1, 2, 2), z_channels=8)
DECODE_ATOL = 1e-4
DECODE_TF32_ATOL = 3e-2


def test_cosmos_decoder_on_the_card_matches_the_cpu(cuda):
    import copy

    from egom2p_torch.tokenizers.cosmos import video_api
    from egom2p_torch.tokenizers.cosmos.network import (CausalDiscreteVideoTokenizer,
                                                        DiscreteVideoConfig)
    net = CausalDiscreteVideoTokenizer(DiscreteVideoConfig(**SMALL_COSMOS))
    net.init_random_(torch.Generator().manual_seed(0))
    cpu = video_api.CausalVideoTokenizer(net)
    card = video_api.CausalVideoTokenizer(copy.deepcopy(net).to(cuda))
    idx = np.random.default_rng(0).integers(0, 64000, (2, 5, 32, 32)).astype(np.int32)
    ref = cpu.decode(idx)
    got = card.decode(idx)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert tuple(got.shape) == tuple(ref.shape) == (2, 17, 256, 256, 3)
    atol = DECODE_TF32_ATOL if video_api.DECODE_TF32 else DECODE_ATOL
    torch.testing.assert_close(got.cpu(), ref, atol=atol, rtol=0)
    if not video_api.DECODE_TF32:
        diff = video_api.tensor2uint8(got).cpu().int() - video_api.tensor2uint8(ref).int()
        assert int(diff.abs().max()) <= 1


def test_checkpoint_round_trip_greedy_tokens_on_the_card(cuda, tmp_path):
    """A model saved with core/checkpoint.py and loaded back through
    cli/eval_common (no --smoke) gives bitwise equal greedy rgb2depth
    tokens on the card."""
    import argparse

    from egom2p_torch.cli import eval_common
    from egom2p_torch.core import checkpoint
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import (GenerationSampler, init_empty_target_modality,
                                               init_full_input_modality)

    name = "egom2p_tiny_6e_6d_swiglu_nobias"
    smoke = argparse.Namespace(model=name, seed=4, smoke=True)
    model = eval_common.load_main_model(smoke, cuda)
    path = checkpoint.save_checkpoint(str(tmp_path), "final", model, args=argparse.Namespace(
        model=name, in_domains=list(eval_common.MODS4), out_domains=list(eval_common.MODS4)))
    loaded = eval_common.load_main_model(
        argparse.Namespace(model="egom2p_base_12e_12d_swiglu_nobias", seed=0, smoke=False,
                           ckpt=path), cuda)
    assert loaded.config == model.config
    sample = {"tok_rgb": {"tensor": np.random.default_rng(1).integers(0, 64000, (2, 5120))
                          .astype(np.int32)}}
    init_full_input_modality(sample, MODALITY_INFO, "tok_rgb")
    init_empty_target_modality(sample, MODALITY_INFO, "tok_depth", 2, 5120)
    greedy = eval_common.roar_schedule("tok_rgb", "tok_depth", temperature=0.0)
    a, b = (GenerationSampler(m).generate(sample, greedy, seed=5)["tok_depth"]["tensor"]
            for m in (model, loaded))
    np.testing.assert_array_equal(a, b)


# the seq VQ-VAE in fp32 on the card against the CPU: the same products in
# another order through 2 + 2 blocks
SEQ_DECODE_ATOL = 1e-4
SEQ_TIE_GAP = 1e-4


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_seq_tokenizer_on_the_card_matches_the_cpu(cuda, domain):
    import copy

    from egom2p_torch.ops.vq import l2norm
    from egom2p_torch.tokenizers.seq_vqvae import SeqTokenizer, seq_vqvae_from_config
    cpu = seq_vqvae_from_config(domain, torch.Generator().manual_seed(0), dim=128, depth=2,
                                num_heads=2)
    card = SeqTokenizer(copy.deepcopy(cpu.net).to(cuda))
    assert card.device.type == "cuda" and not card.tf32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 60, 9 if domain == "cam" else 3)).astype(np.float32)
    if domain == "gaze":
        x[..., 2] = rng.uniform(size=(4, 60)) > 0.2
    lat = cpu.net.encode_latents(torch.from_numpy(x)).detach()
    top2 = torch.topk(l2norm(lat) @ l2norm(cpu.vq_state.embed).t(), 2).values
    clear = (top2[..., 0] - top2[..., 1] > SEQ_TIE_GAP).numpy()
    ref, got = cpu.tokenize(x).numpy(), card.tokenize(x).cpu().numpy()
    np.testing.assert_array_equal(got[clear], ref[clear])
    tokens = rng.integers(0, 256, (4, 30))
    torch.testing.assert_close(card.decode_tokens(tokens).cpu(), cpu.decode_tokens(tokens),
                               atol=SEQ_DECODE_ATOL, rtol=0)


@pytest.mark.parametrize("task,shape,layers_x_steps", [("rgb2cam", (60, 9), 6 * 3),
                                                       ("rgb2gaze", (60, 2), 6 * 5)])
def test_seq_entry_points_on_the_card(cuda, tmp_path, monkeypatch, task, shape, layers_x_steps):
    """rgb2cam / rgb2gaze with --smoke on the tiny model (6 encoder layers):
    the encoder's attention on the flash64 kernel, 2 CFG branches a step."""
    import importlib

    from egom2p_torch.cli import eval_common
    from egom2p_torch.ops.flash64 import flash64_attention
    monkeypatch.setattr(eval_common, "SEQ_CONFIG", dict(dim=128, depth=2, num_heads=2))
    np.savez(tmp_path / f"{task}_0.npz", np.random.default_rng(0).integers(0, 64000, 5120))
    entry = importlib.import_module(f"egom2p_torch.cli.eval_model_{task}")
    flash64_attention.launches = 0
    (rec,) = entry.main(["--smoke", "--model", "egom2p_tiny_6e_6d_swiglu_nobias",
                         "--data", str(tmp_path), "--out", str(tmp_path / "out")])
    assert flash64_attention.launches == 2 * layers_x_steps
    out = np.load(next(iter(rec["outputs"].values())))
    assert out.shape == shape and np.isfinite(out).all()
