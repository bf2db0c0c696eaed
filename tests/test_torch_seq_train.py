"""Training with captions on the port against the JAX trainer: aligned tar
shards of tok_rgb / tok_cam tokens and `.txt` captions, a data config with
the caption in and out and an alphas config with its keep schemes, and
--text_tokenizer_path naming a tokenizer.json the test writes.  The train,
val and fixed-eval batches equal the JAX trainer's bitwise (the JAX side
reads the file through the Hugging Face tokenizer where it is installed,
through its own reader otherwise); then the port's trainer takes 2 steps
and an eval pass on the CPU.
"""
import copy
import json
import tarfile

import jax
import numpy as np
import pytest
import torch

import run_training_egom2p as jax_trainer
from egom2p_torch.cli import run_training
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.utils.text_tokenizer import write_wordpiece_json
from egom2p_tpu.core.mesh import make_mesh
from tests.test_torch_data_shards import _add, assert_batches_equal, write_tree
from tests.test_torch_text import WORDS

torch.set_num_threads(2)
ALPHAS = [0.01, 0.1, 1.0, 10.0]
KEEP = ["random", "all", "binary", "random"]


def write_captions(root, name, samples, seed):
    """root/caption/<name>/shard-NNN.tar beside the token tars: a `.txt`
    caption of seeded words for every key, in the same order."""
    rng = np.random.default_rng(seed)
    shards = sorted({k.rsplit("_", 1)[0] for k in samples})
    d = root / "caption" / name
    d.mkdir(parents=True, exist_ok=True)
    for s, prefix in enumerate(shards):
        with tarfile.open(d / f"shard-{s:03d}.tar", "w") as tar:
            for k in (k for k in samples if k.startswith(prefix + "_")):
                words = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(3, 40))]
                _add(tar, f"{k}.txt", " ".join(words).encode())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    vocab = {"tok_rgb": 1024, "tok_cam": 256}
    pattern, train = write_tree(root, "set", 2, 4, seed=0, vocab=vocab)
    val_pattern, val = write_tree(root, "held_out", 1, 4, seed=1, vocab=vocab)
    write_captions(root, "set", train, seed=2)
    write_captions(root, "held_out", val, seed=3)
    tok = write_wordpiece_json(str(root / "tokenizer.json"), WORDS, num_sentinels=100)
    return (pattern.replace("[rgb,cam]", "[rgb,cam,caption]"),
            val_pattern.replace("[rgb,cam]", "[rgb,cam,caption]"), tok)


def caption_args(tmp_path, tree, *extra, jax_args=True):
    pattern, val_pattern, tok = tree
    mods = ("tok_rgb", "tok_cam", "caption")
    alphas = {"sampling_weights": [1.0] * 4,
              "alphas_mixture": {m: {"input_alphas": ALPHAS, "target_alphas": ALPHAS,
                                     **({"keep": KEEP} if m == "caption" else {})}
                                 for m in mods}}
    (tmp_path / "alphas.json").write_text(json.dumps(alphas))
    train = {"type": "multimodal", "in_domains": "-".join(mods), "out_domains": "-".join(mods),
             "input_alphas": None, "target_alphas": None,
             "alphas_config": str(tmp_path / "alphas.json"), "data_path": pattern,
             "wds_n_repeats": 1, "wds_shuffle_buffer_tar": 3}
    cfg = {"train": {"datasets": {"set": train}, "weights": [1.0]},
           "val": {"datasets": {"set": {"data_path": val_pattern}}}}
    (tmp_path / "data.json").write_text(json.dumps(cfg))
    argv = ["--data_config", str(tmp_path / "data.json"), "--text_tokenizer_path", tok,
            "--batch_size", "2", "--num_input_tokens", "48", "--num_target_tokens", "48",
            "--fixed_eval_input_tokens", "40", "--fixed_eval_target_tokens", "40",
            "--seed", "5", *extra]
    return run_training.get_args(argv), jax_trainer.get_args(argv) if jax_args else None


def test_caption_batches_match_the_jax_trainer(tree, tmp_path):
    port_args, jax_args = caption_args(tmp_path, tree)
    mesh = make_mesh(devices=jax.devices()[:1])
    (port, port_domains), (ref, ref_domains) = (run_training.setup_data(port_args),
                                                jax_trainer.setup_data(jax_args, mesh))
    assert port_domains == ref_domains == ["caption", "tok_cam", "tok_rgb"]
    a, b = iter(port), iter(ref)
    visible = targets = 0
    try:
        for _ in range(3):
            batch = next(a)
            assert_batches_equal(batch, next(b))
            assert batch["caption"]["tensor"].shape == (2, 514)
            visible += int((~batch["caption"]["input_mask"]).sum())
            targets += int((~batch["caption"]["target_mask"]).sum())
    finally:
        a.close()
        b.close()
    assert visible > 0 and targets > 0
    (pv, pf), (rv, rf) = (run_training.setup_val_data(port_args),
                          jax_trainer.setup_val_data(jax_args, mesh))
    for port_f, ref_f in ((pv, rv), (pf, rf)):
        a, b = port_f["set"](), ref_f["set"]()
        try:
            assert_batches_equal(next(a), next(b))
        finally:
            a.close()
            b.close()


def test_trainer_takes_captions_on_the_cpu(tree, tmp_path, monkeypatch):
    """2 steps and an eval pass of the tiny model with the caption in and
    out: finite losses for each modality, logged; the caption's head and
    embeddings move.  The caption's vocabulary is cut to 256 and tok_rgb's
    to 1024 (the shards' tokens lie below)."""
    for m, v in (("tok_rgb", 1024), ("caption", 256)):
        small = copy.deepcopy(MODALITY_INFO[m])
        small["vocab_size"] = small["embed_spec"]["vocab_size"] = v
        monkeypatch.setitem(MODALITY_INFO, m, small)
    out = tmp_path / "out"
    states = {}

    def on_epoch(epoch, model, stats):
        states[epoch] = {k: v.clone() for k, v in model.state_dict().items()}

    args, _ = caption_args(tmp_path, tree, "--model", "egom2p_tiny_6e_6d_swiglu_nobias",
                           "--epochs", "1", "--epoch_size", "4", "--eval_iters", "1",
                           "--lr_schedule", "constant", "--blr", "1e-2", "--device", "cpu",
                           "--output_dir", str(out), jax_args=False)
    run_training.main(args, on_epoch=on_epoch)
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    train = next(r for r in records if "loss_caption" in r)
    assert np.isfinite(train["loss_caption"]) and train["loss_caption"] > 0
    ev = next(r for r in records if "val_set_loss_caption" in r)
    assert all(np.isfinite(v) for v in ev.values())
    from egom2p_torch.models.egom2p import create_model
    init = create_model(args.model, ["caption", "tok_cam", "tok_rgb"],
                        ["caption", "tok_cam", "tok_rgb"])
    init.init_random_(torch.Generator().manual_seed(args.seed))
    for k in ("encoder_embeddings.caption.token_emb.weight",
              "decoder_embeddings.caption.token_emb.weight", "decoder_embeddings.caption.mod_emb"):
        assert not torch.equal(states[0][k], init.state_dict()[k]), k
