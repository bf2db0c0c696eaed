"""The frozen references against the port at small sizes on the CPU: the
Cosmos tokenizer's tokens and decoded video, EgoM2P's training loss and
gradients and its guided ROAR logits at fp32, AdamW with clipping, and the
seeded weights that both sides take; the masking's budgets against the
program's masker."""
import numpy as np
import pytest
import torch

from perfbench import core, weights
from perfbench.reference import masking, serve_check, train_check
from perfbench.reference.egom2p import EgoM2PReference, adamw_reference, egom2p_shapes
from perfbench.tests import small

torch.set_num_threads(4)
CPU = torch.device("cpu")


def _program_tokenizer():
    from egom2p_torch.tokenizers.cosmos.network import (CausalDiscreteVideoTokenizer,
                                                        DiscreteVideoConfig)
    from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer
    t = small.SMALL_TOKENIZER
    net = CausalDiscreteVideoTokenizer(DiscreteVideoConfig(
        channels=t["channels"], channels_mult=tuple(t["channels_mult"]),
        z_channels=t["z_channels"]))
    weights.fill_module_(net.named_parameters(), 7, "cosmos")
    return CausalVideoTokenizer(net)


def test_seeded_weights_repeat_and_follow_the_init_rules():
    shapes = {"a.norm.weight": (4,), "a.conv3d.weight": (3, 2, 1, 1, 5), "a.conv3d.bias": (3,)}
    w1, w2 = weights.draw(shapes, 5, "cosmos", CPU), weights.draw(shapes, 5, "cosmos", CPU)
    assert all(torch.equal(w1[n], w2[n]) for n in shapes)
    assert torch.equal(w1["a.norm.weight"], torch.ones(4))
    assert torch.equal(w1["a.conv3d.bias"], torch.zeros(3))
    assert 0.05 < float(w1["a.conv3d.weight"].std()) < 0.6  # 10 ** -0.5
    assert not torch.equal(weights.draw(shapes, 6, "cosmos", CPU)["a.conv3d.weight"],
                           w1["a.conv3d.weight"])


@pytest.mark.parametrize("name", ["egom2p_base", "egom2p_large"])
def test_reference_parameter_set_is_the_programs(name):
    from perfbench import core
    from egom2p_torch.models.egom2p import create_model
    cfg = core.load_json("configs", f"{name}.json")
    mods = sorted(cfg["modalities"])
    with torch.device("meta"):
        model = create_model(cfg["model"]["registry_name"], mods, mods)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        egom2p_shapes(cfg["model"], cfg["modalities"])


def test_cosmos_reference_tokens_and_video_match_the_port():
    from egom2p_torch.generate.decode import decode_video_tokens
    prog = _program_tokenizer()
    ref = serve_check.tokenizer_reference(small.SMALL_TOKENIZER, 7, CPU)
    clips = weights.clip_pool(3, 2, (16, 32, 32, 3), CPU)
    got = prog.forward(clips)
    want = ref.tokenize(clips).numpy()
    assert got.shape == want.shape == (2, 5, 4, 4)
    assert (got != want).sum() == 0
    video = decode_video_tokens(got.reshape(2, -1), prog, key="tok_depth", grid=(5, 4, 4))
    ref_video = ref.decode(torch.from_numpy(got), 16, gray=True).numpy()
    assert np.abs(video.astype(int) - ref_video.astype(int)).max() <= 1


def _program_model(seed):
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.data.modality_info import make_scaled_modality_info
    info = make_scaled_modality_info(video_grid=(2, 3, 3), video_vocab=96, seq_len=6,
                                     seq_vocab=32)
    mods = sorted(info)
    model = create_model(small.TINY["registry_name"], mods, mods, modality_info=info,
                         compute_dtype="float32")
    weights.fill_module_(model.named_parameters(), seed, "egom2p")
    cfg = {"model": dict(small.TINY), "modalities": {
        m: {"vocab_size": info[m]["vocab_size"],
            "grid": list(info[m]["embed_spec"].get("grid", (info[m]["max_tokens"],)))}
        for m in mods}}
    return model, info, cfg


def _masked_batch(info, rows, seed, n_in, n_tgt):
    from egom2p_torch.data.masking import UnifiedMasking
    rng = np.random.default_rng(seed)
    info = {m: {**i, "input_alphas": [1.0], "target_alphas": [1.0]} for m, i in info.items()}
    mask = UnifiedMasking(info, n_in, n_tgt, sampling_weights=None, seed=seed)
    samples = [mask({m: rng.integers(0, info[m]["vocab_size"], info[m]["max_tokens"])
                     .astype(np.int32) for m in info}) for _ in range(rows)]
    return {m: {k: np.stack([s[m][k] for s in samples]) for k in samples[0][m]} for m in info}


def test_training_loss_gradients_and_adamw_match_the_port():
    from egom2p_torch.core.optim import Optimizer
    model, info, cfg = _program_model(11)
    batch = _masked_batch(info, 3, 4, 12, 12)
    dev = {m: {k: torch.from_numpy(v) for k, v in d.items()} for m, d in batch.items()}
    loss, mod_loss = model(dev, 12, 12, "mod")
    loss.backward()
    opt = Optimizer(model, [1e-3], weight_decay=0.05, betas=(0.9, 0.95), clip_grad=1.0)
    opt.step()
    tr = {"blr": 1e-3 * 256 / 3, "opt_betas": [0.9, 0.95], "weight_decay": 0.05,
          "clip_grad": 1.0, "num_input_tokens": 12, "num_target_tokens": 12}
    ref = train_check.reference_steps(cfg, tr, 11, [batch], CPU, global_batch=3)
    assert abs(ref["losses"][0]["loss"] - float(loss.detach())) < 1e-4
    for m, v in mod_loss.items():
        assert abs(ref["losses"][0][f"loss_{m}"] - float(v)) < 1e-4
    state = opt.adamw.state
    for n, p in model.named_parameters():
        g1 = float(state[p]["exp_avg"].norm()) / 0.1 if p in state else 0.0
        assert abs(g1 - ref["grad1"][n]) <= 1e-4 * max(ref["grad1"][n], 1e-3), n
    start = weights.draw({n: tuple(p.shape) for n, p in model.named_parameters()}, 11,
                         "egom2p", CPU)
    changes = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    for n, v in changes.items():
        assert abs(v - ref["change"][n]) <= 1e-3 * max(ref["change"][n], 1e-6) + 1e-7, n


def test_adamw_reference_is_torch_adamw_with_clipping():
    torch.manual_seed(0)
    p = [torch.randn(4, 3), torch.randn(5)]
    g = [torch.randn(4, 3) * 3, torch.randn(5) * 3]
    mine = [t.clone() for t in p]
    state = [{}, {}]
    for _ in range(2):
        adamw_reference(mine, g, state, [True, False], 1e-2, (0.9, 0.95), 0.05, 1.0)
    theirs = [torch.nn.Parameter(t.clone()) for t in p]
    opt = torch.optim.AdamW([{"params": [theirs[0]], "weight_decay": 0.05},
                             {"params": [theirs[1]], "weight_decay": 0.0}], lr=1e-2,
                            betas=(0.9, 0.95), eps=1e-8)
    for _ in range(2):
        for t, gg in zip(theirs, g):
            t.grad = gg.clone()
        torch.nn.utils.clip_grad_norm_(theirs, 1.0)
        opt.step()
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b.detach(), atol=1e-6)


def test_guided_logits_match_the_port_step():
    from egom2p_torch.generate.sampler import GenerationSampler  # noqa: F401
    model, info, cfg = _program_model(13)
    model.eval()
    ref = EgoM2PReference(weights.draw(egom2p_shapes(cfg["model"], cfg["modalities"]), 13,
                                       "egom2p", CPU), cfg["model"], cfg["modalities"])
    L = info["tok_depth"]["max_tokens"]
    rng = np.random.default_rng(0)
    cond = rng.integers(0, 96, (1, L))
    served = rng.integers(0, 96, (1, L))
    known, query = np.array([1, 4, 7]), np.array([0, 2, 5, 8])

    def mod_dict(with_cond):
        d = {}
        for m in sorted(info):
            n = info[m]["max_tokens"]
            t = np.zeros((1, n), np.int64)
            im = np.ones((1, n), bool)
            if m == "tok_rgb" and with_cond:
                t[:] = cond
                im[:] = False
            if m == "tok_depth":
                t[0, known] = served[0, known]
                im[0, known] = False
            d[m] = {"tensor": torch.from_numpy(t), "input_mask": torch.from_numpy(im),
                    "target_mask": torch.ones(1, n, dtype=torch.bool),
                    "decoder_attention_mask": torch.zeros(1, n, dtype=torch.int32)}
        return d

    with torch.no_grad():
        out = []
        for with_cond in (True, False):
            md = mod_dict(with_cond)
            n_enc = int(sum((~d["input_mask"]).sum() for d in md.values()))
            ctx, mask = model.forward_enc_context(md, max(n_enc, 1))
            ids = torch.from_numpy(query)[None]
            out.append(model.forward_dec_subset_logits(md, "tok_depth", ctx, mask, ids)[0])
        want = out[1] + 2.0 * (out[0] - out[1])
        got = ref.guided_logits(
            {"tok_rgb": (torch.arange(L), torch.from_numpy(cond[0]))},
            {"tok_depth": (torch.from_numpy(known), torch.from_numpy(served[0, known]))},
            "tok_depth", torch.from_numpy(query), 2.0)
    assert torch.allclose(got, want, atol=2e-4)


def test_roar_positions_are_the_samplers():
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.generate.schedules import linear_schedule
    total, steps, seed = 80, 3, 2 ** 31 + 77
    assert serve_check.linear_schedule(steps, total) == [int(k) for k in
                                                         linear_schedule(steps, total)]
    sampler = GenerationSampler.__new__(GenerationSampler)
    done = np.zeros((1, total), bool)
    for s, (k, pos) in enumerate(zip(serve_check.linear_schedule(steps, total),
                                     serve_check.step_positions(seed, serve_check.linear_schedule(
                                         steps, total), total))):
        ids = sampler._select_positions(done, k, np.random.default_rng(seed + s), True)[0]
        assert np.array_equal(np.sort(ids), pos)
        done[0, ids] = True


def test_masking_budgets_are_the_programs():
    """The program's masker over 4000 rows of the base traffic lies within
    sampling error of the reference budgets' means, and keeps their rule."""
    from egom2p_torch.data.masking import UnifiedMasking
    from egom2p_torch.data.modality_info import MODALITY_INFO
    tr = core.load_json("traffic", "mod4.b8.json")
    cfg = core.load_json("configs", "egom2p_base.json")
    mods = sorted(tr["shard_dirs"])
    counts = {m: int(np.prod(cfg["modalities"][m]["grid"])) for m in mods}
    info = {m: {**MODALITY_INFO[m], **tr["alphas"]["alphas_mixture"][m]} for m in mods}
    masker = UnifiedMasking(info, 2048, 2048, sampling_weights=tr["alphas"]["sampling_weights"],
                            seed=3)
    sample = {m: np.zeros(counts[m], np.int32) for m in mods}
    rows = [masker(sample) for _ in range(4000)]
    fed_in = np.array([[int((~r[m]["input_mask"]).sum()) for m in mods] for r in rows])
    fed_tgt = np.array([[int((~r[m]["target_mask"]).sum()) for m in mods] for r in rows])
    z = masking.live_count_z(fed_in.sum(1), fed_tgt.sum(1), tr["alphas"], counts, 2048, 2048, 5)
    assert z["live_count_z"] < 4.5, z
    assert train_check.judge_budgets(fed_in, fed_tgt, [counts[m] for m in mods], 2048, 2048) == 0


def test_budget_rule_by_hand():
    """Sizes (30, 5120): a row short of its budget is bad unless a modality
    is full; more than the budget is always bad."""
    size = [30, 5120]
    inputs = np.array([[10, 2038], [30, 1000], [10, 1000], [0, 2049], [30, 2018]])
    targets = np.array([[20, 2028], [0, 1500], [20, 2028], [0, 2048], [0, 2048]])
    # rows: exact; cam input whole (short inputs, cam full for targets);
    # short inputs with nothing full; over budget; exact
    assert train_check.judge_budgets(inputs, targets, size, 2048, 2048) == 2
    short_tgt = np.array([[10, 2038]]), np.array([[5, 2000]])
    assert train_check.judge_budgets(*short_tgt, size, 2048, 2048) == 1
    full_tgt = np.array([[10, 2038]]), np.array([[20, 2000]])
    assert train_check.judge_budgets(*full_tgt, size, 2048, 2048) == 0
