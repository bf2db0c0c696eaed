"""The loss's heads over their own rows (models/egom2p.py:forward_loss).

Each head's rows of y and of the targets are gathered before its CE.  Held
against the CE of every head over every decoder row, with weight 0 on the
rows of other modalities and on dead slots (the loss as it was computed
before the rows were gathered): the loss, the modalities' losses and the
gradients of y and of every head, at fp32, on the flash route (its plain
version on the CPU) and on the plain route (EGOM2P_FLASH_CE=0).  Also the
counts handed to `count_reduce` and the rows the counters count.  No JAX
here.
"""
import math

import numpy as np
import pytest
import torch

import egom2p_torch.models.egom2p as port_egom2p
from egom2p_torch.core import tracing
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.ops import flash_ce

torch.set_num_threads(2)

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
B, M = 2, 96
# fp32 sums over the same products in another order (chunk bounds)
RTOL = 1e-6


@pytest.fixture(scope="module")
def model():
    """Dim 384 (the flash route takes it), the released vocabularies: two
    64k heads and the 256-code cam and gaze sequence heads."""
    torch.manual_seed(0)
    info = {m: MODALITY_INFO[m] for m in MODS4}
    return create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32",
                        encoder_depth=1, decoder_depth=1)


def _batch(model, case, seed=0):
    """(y, target ids, modality ids) of B x M decoder slots.  "interleaved":
    runs of random length cycling through the modalities, then a dead
    tail; "all_live": the same with no dead slot; "no_rgb": as
    interleaved, with no row of tok_rgb."""
    rng = np.random.default_rng(seed)
    info = model.mod_info
    mods = [m for m in MODS4 if not (case == "no_rgb" and m == "tok_rgb")]
    mod_ids = np.full((B, M), -1, np.int32)
    targets = np.zeros((B, M), np.int32)
    for b in range(B):
        live = M if case == "all_live" else int(rng.integers(M // 2, M - 8))
        pos = 0
        while pos < live:
            m = mods[int(rng.integers(len(mods)))]
            n = min(int(rng.integers(1, 12)), live - pos)
            mod_ids[b, pos:pos + n] = info[m]["id"]
            targets[b, pos:pos + n] = rng.integers(0, info[m]["vocab_size"], n)
            pos += n
    y = torch.from_numpy(rng.standard_normal((B, M, model.config.dim)).astype(np.float32))
    return y, torch.from_numpy(targets), torch.from_numpy(mod_ids)


def _every_row_loss(model, y, target_ids, mod_ids, flash):
    """Each head over every decoder row, weight 0 on the others' rows."""
    D = y.shape[-1]
    yf, t = y.reshape(-1, D), target_ids.reshape(-1)
    mod_loss = {}
    for m in MODS4:
        w = mod_ids.reshape(-1) == model.mod_info[m]["id"]
        tm = torch.where(w, t, torch.zeros_like(t))
        emb = model.decoder_embeddings[m]
        if flash and emb.vocab_size >= 4096 and flash_ce.takes_dim(D):
            total = flash_ce.flash_ce_total(yf, emb.logits_weight, tm, w.float())
        else:
            logits = emb.forward_logits(yf)
            gold = logits.gather(1, tm.long()[:, None])[:, 0]
            total = ((logits.logsumexp(dim=-1) - gold) * w.float()).sum()
        count = w.sum().float()
        mod_loss[m] = torch.where(count > 0, total / count.clamp(min=1.0), torch.zeros_like(total))
    return sum(mod_loss.values()) / len(mod_loss), mod_loss


def _grads(model, y):
    heads = {m: model.decoder_embeddings[m].logits_weight.grad for m in MODS4}
    return y.grad, heads


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * want.abs().max().item())


@pytest.mark.parametrize("case", ["interleaved", "all_live", "no_rgb"])
@pytest.mark.parametrize("route", ["flash", "plain"])
def test_heads_over_their_own_rows_match_every_row(model, monkeypatch, route, case):
    """Loss, the modalities' losses and the gradients of y and of every head
    against the CE over every row.  A modality with no row launches no CE,
    reads 0 and gets zero gradients on its head (not None: the optimizer
    steps it as before)."""
    if route == "plain":
        monkeypatch.setenv("EGOM2P_FLASH_CE", "0")
    y, t, mod_ids = _batch(model, case)
    calls = []
    real_ce, real_mm = port_egom2p.flash_ce_total, port_egom2p.matmul_f32
    monkeypatch.setattr(port_egom2p, "flash_ce_total",
                        lambda yy, *a, **k: calls.append(len(yy)) or real_ce(yy, *a, **k))
    monkeypatch.setattr(port_egom2p, "matmul_f32",
                        lambda yy, *a, **k: calls.append(len(yy)) or real_mm(yy, *a, **k))
    model.eval()
    results = []
    for gathered in (True, False):
        model.zero_grad(set_to_none=True)
        yr = y.clone().requires_grad_()
        if gathered:
            loss, mod_loss = model.forward_loss(yr, t, mod_ids, "mod", list(MODS4))
            n_calls = len(calls)
        else:
            loss, mod_loss = _every_row_loss(model, yr, t, mod_ids, route == "flash")
        loss.backward()
        results.append((loss, mod_loss, *_grads(model, yr)))
    (loss, mod_loss, dy, heads), (rloss, rmod, rdy, rheads) = results

    # one CE call a head that has rows (a chunk: R < 2048), over those rows
    counts = {m: int((mod_ids == model.mod_info[m]["id"]).sum()) for m in MODS4}
    assert sorted(calls[:n_calls]) == sorted(c for c in counts.values() if c)
    _close(loss, rloss)
    for m in MODS4:
        _close(mod_loss[m], rmod[m])
        _close(heads[m], rheads[m])
    _close(dy, rdy)
    assert torch.count_nonzero(dy.reshape(-1, y.shape[-1])[mod_ids.reshape(-1) < 0]) == 0
    if case == "no_rgb":
        assert counts["tok_rgb"] == 0 and mod_loss["tok_rgb"].item() == 0.0
        assert heads["tok_rgb"] is not None and torch.count_nonzero(heads["tok_rgb"]) == 0


@pytest.mark.parametrize("loss_type", ["token", "weighted_mod"])
def test_loss_types_weigh_the_gathered_heads_as_before(model, loss_type):
    """The 'token' and 'weighted_mod' losses over the gathered heads: the
    same as each head over every row, weighed by the same counts."""
    y, t, mod_ids = _batch(model, "interleaved", seed=1)
    model.eval()
    with torch.no_grad():
        loss, mod_loss = model.forward_loss(y, t, mod_ids, loss_type, list(MODS4))
        _, rmod = _every_row_loss(model, y, t, mod_ids, True)
    info = model.mod_info
    counts = {m: float((mod_ids == info[m]["id"]).sum()) for m in MODS4}
    if loss_type == "weighted_mod":
        rmod = {m: v / math.log(info[m]["vocab_size"]) * math.log(256.0)
                for m, v in rmod.items()}
        want = sum(rmod.values()) / 4
    else:
        weights = {m: counts[m] * info[m]["vocab_size"] for m in MODS4}
        want = sum(rmod[m] * weights[m] for m in MODS4) / sum(weights.values())
    for m in MODS4:
        _close(mod_loss[m], rmod[m])
    _close(loss, want)


@pytest.mark.parametrize("case", ["interleaved", "no_rgb"])
def test_count_reduce_and_counters_see_the_live_rows(model, case):
    """`count_reduce` receives the fp32 counts it received before (each
    head's live rows, in present_mods' order); in training the counters
    add the rows the heads compute and the heads x decoder rows, every
    batch; in evaluation they count nothing."""
    y, t, mod_ids = _batch(model, case, seed=2)
    info = model.mod_info
    want = torch.stack([(mod_ids == info[m]["id"]).sum().float() for m in MODS4])
    seen = []

    def reduce(c):
        seen.append(c.clone())
        return c * 2  # as if a second rank held the same rows

    tracing.reset()
    try:
        model.train()
        with torch.no_grad():
            for _ in range(2):
                model.forward_loss(y, t, mod_ids, "mod", list(MODS4), count_reduce=reduce)
            model.eval()
            loss, _ = model.forward_loss(y, t, mod_ids, "mod", list(MODS4), count_reduce=reduce)
            _, rmod = _every_row_loss(model, y, t, mod_ids, True)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.reset()
        model.eval()
    assert len(seen) == 3 and all(s.dtype == torch.float32 and torch.equal(s, want) for s in seen)
    assert counters == {"train.ce_rows": 2 * int((mod_ids >= 0).sum()),
                        "train.ce_row_slots": 2 * 4 * B * M}
    # each head's total over twice its count: half the one-rank loss
    _close(loss, sum(rmod.values()) / 4 / 2)
