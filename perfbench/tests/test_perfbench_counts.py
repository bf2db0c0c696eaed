"""The FLOP and byte counters against hand counts."""
import numpy as np
import pytest
import torch

from perfbench import core, work
from perfbench.drivers.serve import cosmos_flops
from perfbench.tests import small

torch.set_num_threads(4)
PEAKS = core.peaks()


def test_base_training_step_by_the_copied_formula_is_35_45_tflop():
    per_sample = work.train_flops_per_sample()
    assert round(8 * per_sample / 1e12, 2) == 35.45
    # large at B = 4: 52.36 TFLOP (PR 18's log), its MLP hidden int(2 * 4 * 1020 / 3)
    large = work.train_flops_per_sample(n_layers=24, dim=1020, h=2720)
    assert round(4 * large / 1e12, 2) == 52.36


def test_attention_cost_by_hand():
    fl, nb = work.attention_cost(rows=10, keys_x_rows=10 * 20, keys=20, heads=2, hd=64,
                                 backward=False)
    assert fl == 4 * 10 * 20 * 64 * 2
    assert nb == 2 * 2 * 64 * (2 * 10 + 2 * 20)
    fl_b, nb_b = work.attention_cost(10, 200, 20, 2, 64, backward=True)
    assert fl_b == 2.5 * fl and nb_b == 2 * 2 * 64 * (4 * 10 + 4 * 20)
    assert work.bound_s(1e12, 1.0, 1e12, 1e9) == 1.0
    assert work.bound_s(1.0, 1e9, 1e12, 1e9) == 1.0


def _tiny_model():
    from egom2p_torch.data.modality_info import make_scaled_modality_info
    from egom2p_torch.models.egom2p import create_model
    info = make_scaled_modality_info(video_grid=(2, 3, 3), video_vocab=96, seq_len=6, seq_vocab=32)
    mods = sorted(info)
    return create_model(small.TINY["registry_name"], mods, mods, modality_info=info), info


def test_work_counter_counts_a_training_forward_by_hand():
    """One row: 5 visible tokens, targets 3 in one modality and 2 in
    another; the encoder attends 5 x 5, the decoder 3 x 3 + 2 x 2 within its
    modalities and 5 x 5 across, the loss' heads 3 and 2 rows."""
    model, info = _tiny_model()
    counter = work.WorkCounter(model, PEAKS)
    counter.active, counter.tag = True, 0
    md = {}
    for m in sorted(info):
        n = info[m]["max_tokens"]
        im = np.ones((1, n), bool)
        tm = np.ones((1, n), bool)
        if m == "tok_rgb":
            im[0, :5] = False
            tm[0, 5:8] = False
        if m == "tok_cam":
            tm[0, :2] = False
        attn = np.zeros((1, n), np.int32)
        if (~tm).any():
            attn[0, np.flatnonzero(~tm[0])[0]] = int((~tm).sum())
        md[m] = {"tensor": torch.zeros(1, n, dtype=torch.long), "input_mask": torch.from_numpy(im),
                 "target_mask": torch.from_numpy(tm),
                 "decoder_attention_mask": torch.from_numpy(attn)}
    loss, _ = model(md, 8, 8, "mod")
    loss.backward()
    got = counter.reduce()
    H, hd, D, F, L = 6, 64, 384, 1024, 6
    enc = 4.0 * 25 * hd * H
    dec = 4.0 * (9 + 4) * hd * H + 4.0 * 5 * 5 * hd * H
    assert got["attn_fwd_flops"] == pytest.approx(L * (enc + dec))
    assert got["attn_bwd_flops"] == pytest.approx(2.5 * L * (enc + dec))
    head = 2.0 * D * (3 * 96 + 2 * 32)
    assert got["ce_fwd_flops"] == pytest.approx(head)
    lin_enc = 5 * 2.0 * (4 * D * D + 3 * D * F)
    lin_dec = 5 * (2.0 * (4 * D * D + 3 * D * F) + 4.0 * D * D) + 5 * 4.0 * D * D
    assert got["model_flops"] == pytest.approx(3 * (L * (lin_enc + lin_dec + enc + dec) + head))
    counter.close()
    assert "forward_loss" not in model.__dict__


def test_cosmos_flops_grow_with_the_batch():
    enc1, dec1 = cosmos_flops(small.SMALL_TOKENIZER, (16, 32, 32, 3), 1)
    enc2, dec2 = cosmos_flops(small.SMALL_TOKENIZER, (16, 32, 32, 3), 2)
    assert enc1 > 0 and dec1 > enc1
    assert enc2 == pytest.approx(2 * enc1) and dec2 == pytest.approx(2 * dec1)
