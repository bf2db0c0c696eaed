"""The video (rgb / depth) VQ-VAE on the port against the JAX package, on the
CPU at a small size: 8 frames of 64 x 64, tubelet 2, patch 8 (4 x 8 x 8 =
256 tokens), 6 heads of 64 (the 3-D sincos posemb needs a width divisible by
6, the flash64 kernels an even count of 64-wide heads), 1 + 1 blocks,
latent 8, 32 codes; the JAX weights carried by compat/from_jax.py.

Attention is compared twice.  With the port forced dense (no flash64 and no
stock route: both patched off) the port computes what JAX's CPU einsum path
does, in fp32: tokens equal, values within FP32_TOL of a tensor's largest.
On the port's default route the 256 x 256 attention takes the flash64_train
kernels (their plain versions on CPU tensors), which round q / k / v, p and
dS to bf16, as JAX's kernels do on the TPU: values within BF16_TOL of a
tensor's largest (the bf16 tolerance of tests/test_torch_train.py), and a
token may differ only where two codes are within CODE_GAP of each other.

Also: VideoClipDataset's train / val / tokenize samples bitwise the JAX
dataset's, the DiVAE warm start against JAX's on a .safetensors file the
test writes, and the CLI's --domain rgb train, resume, --eval_only and
--tokenize (tests/test_video_vqvae.py:112's run).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_torch.models.transformer as port_transformer
import egom2p_torch.ops.flash64_train as port_f64t
import egom2p_torch.ops.flash_attention as port_fa
from egom2p_torch.cli import run_training_vqvae as tcli
from egom2p_torch.compat.from_jax import video_vqvae_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_divae_encoder_warm_start
from egom2p_torch.data import video_dataset as tvd
from egom2p_torch.tokenizers import video_vqvae as tvv
from egom2p_torch.train.vqvae_train import reconst_loss
from egom2p_tpu.data import video_dataset as jvd
from egom2p_tpu.tokenizers import video_vqvae as jvv
from egom2p_tpu.train.vqvae_train import init_train_state, make_vqvae_train_step

torch.set_num_threads(2)

SMALL = dict(num_frames=8, image_size=64, tubelet_t=2, patch_size=8, codebook_size=32,
             latent_dim=8, dim=384, depth=1, num_heads=6)
K, D, N_TOK = 32, 8, 256
FP32_TOL = 2e-5    # of each tensor's largest magnitude: fp32 sums in another order
BF16_TOL = 1e-2    # bf16 q / k / v / p / dS in the kernels' plain versions
# gradients through the kernels' bf16 dS against JAX's fp32 einsum (the
# 1e-2 of tests/test_torch_train.py holds kernels against JAX's kernels):
# 1.3e-2 seen, on the decoder's qkv weight
BF16_GRAD_TOL = 3e-2
CODE_GAP = 2e-2    # cosine similarity: codes this close may swap under bf16 attention
THRESHOLD = 2.0    # the video domains' dead-code threshold: codes expire at step 1


@pytest.fixture(scope="module")
def pair():
    jt = jvv.video_vqvae_from_config("rgb", jax.random.PRNGKey(0), **SMALL)
    tt = tvv.video_vqvae_from_config("rgb", **SMALL)
    tt.net.load_state_dict(video_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    return jt, tt


@pytest.fixture(params=["dense", "kernels"])
def route(request, monkeypatch):
    """'dense': the port's attention on the dense path; 'kernels': its
    default routing, with the flash64_train calls counted."""
    calls = {"n": 0}
    if request.param == "dense":
        monkeypatch.setattr(port_transformer, "_try_flash64", lambda *a: None)
        monkeypatch.setattr(port_fa, "kernel_head_dim", lambda hd: None)
    else:
        real = port_f64t.flash64_train_attention

        def spy(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        monkeypatch.setattr(port_f64t, "flash64_train_attention", spy)
    return request.param, calls


def _clips(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 8, 64, 64, 3)).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of its max (limit {tol})"
    return err


def _swapped_tokens_are_near_ties(t_tok, j_tok, lat, embed):
    """Where the tokens differ, the two codes' cosine similarities to JAX's
    latent are within CODE_GAP."""
    diff = t_tok != j_tok
    if not diff.any():
        return 0
    lat = lat.reshape(-1, D)[diff.reshape(-1)]
    lat = lat / np.linalg.norm(lat, axis=-1, keepdims=True)
    e = embed / np.linalg.norm(embed, axis=-1, keepdims=True)
    gap = np.abs((lat * e[t_tok[diff]]).sum(-1) - (lat * e[j_tok[diff]]).sum(-1))
    assert gap.max() <= CODE_GAP, gap.max()
    return int(diff.sum())


def test_tokenize_and_decode_match_jax(pair, route):
    jt, tt = pair
    kind, calls = route
    x = _clips(1)
    j_lat = np.asarray(jt.module.apply(jt.params, jnp.asarray(x),
                                       method=jvv.VideoAutoencoder.encode_latents))
    j_tok = np.asarray(jt.tokenize(jnp.asarray(x)))
    t_tok = tt.tokenize(x).numpy()
    assert t_tok.shape == j_tok.shape == (2, 4, 8, 8)
    # the encoder's one block, 256^2 with no mask, on the kernel
    assert calls["n"] == (0 if kind == "dense" else 1)
    tol = FP32_TOL if kind == "dense" else BF16_TOL
    with torch.no_grad():
        _close(tt.net.encode_latents(torch.from_numpy(x)).numpy(), j_lat, tol, "latents")
    if kind == "dense":
        np.testing.assert_array_equal(t_tok, j_tok)
    else:
        _swapped_tokens_are_near_ties(t_tok, j_tok, j_lat, np.asarray(jt.vq_state.embed))
    # the same tokens decoded, and the whole round trip
    _close(tt.decode_tokens(torch.from_numpy(j_tok.copy())).numpy(),
           np.asarray(jt.decode_tokens(jnp.asarray(j_tok))), tol, "decode")
    assert tt.autoencode(x).shape == x.shape


def _jax_grads_step(jt, batch, key):
    """JAX's train step with a transformation that keeps the gradients as
    its state and applies no update: (metrics, gradients, new VQ state)."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
    step = make_vqvae_train_step(jt.module, jt.vq_cfg, keep)
    state, metrics = step(init_train_state(jt.params, keep, jt.vq_state), jnp.asarray(batch), key)
    return metrics, state.opt_state, state.vq_state


def test_train_step_matches_jax(route):
    """One step's loss terms, every parameter's gradient and the EMA
    codebook with its expired codes, on both attention routes."""
    kind, calls = route
    knobs = dict(SMALL, threshold_ema_dead_code=THRESHOLD)
    jt = jvv.video_vqvae_from_config("rgb", jax.random.PRNGKey(3), **knobs)
    tt = tvv.video_vqvae_from_config("rgb", **knobs)
    tt.net.load_state_dict(video_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    batch, key = _clips(2), jax.random.PRNGKey(4)
    j_metrics, j_grads, j_vq = _jax_grads_step(jt, batch, key)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (K,), 0, 2 * N_TOK)))
    net = tt.net.train()
    pred, commit, tokens = net.autoencode_train(torch.from_numpy(batch), replace_idx=idx)
    rec = reconst_loss(pred, torch.from_numpy(batch), "mse", 3)
    (rec + commit).backward()
    tol = FP32_TOL if kind == "dense" else BF16_TOL
    assert calls["n"] == (0 if kind == "dense" else 2)
    np.testing.assert_allclose(rec.item(), float(j_metrics["reconst_loss"]), rtol=tol)
    np.testing.assert_allclose(commit.item(), float(j_metrics["code_loss"]), rtol=tol)
    want = video_vqvae_state_dict_from_jax(j_grads, j_vq, tt)
    for name, p in net.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), tol if kind == "dense" else BF16_GRAD_TOL, name)
    expired = np.asarray(j_vq.cluster_size) < THRESHOLD
    assert expired.any()
    if kind == "dense":  # the kernels' rounding may move a latent's code
        for name in ("embed", "cluster_size"):
            _close(getattr(net.quantize.state, name).numpy(), np.asarray(getattr(j_vq, name)),
                   FP32_TOL, name)


def _write_clips(root, shapes, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, (t, h, w) in enumerate(shapes):
        np.save(os.path.join(root, f"c{i}.npy"),
                rng.integers(0, 255, (t, h, w, channels)).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("domain", ["rgb", "depth"])
def test_video_dataset_samples_bitwise(tmp_path, domain):
    """Train (random windows and the four rgb augmentations), val and
    tokenize samples and the batch iterator, equal to the JAX dataset's;
    a clip under the crop is zoomed up first; with RandAugment and random
    erasing on, the draws (the generator's state after each sample) and
    the clips are the JAX dataset's too, bitwise (data/rand_augment.py
    gives Pillow's bytes)."""
    root = _write_clips(tmp_path / "v", [(40, 40, 48), (12, 36, 36), (70, 32, 40)])
    kw = dict(clip_len=6, crop_size=32, frame_sample_rate=2, domain=domain, use_npy=True, seed=3)
    for mode in ("train", "val", "tokenize"):
        j, t = jvd.VideoClipDataset(root, mode=mode, **kw), tvd.VideoClipDataset(root, mode=mode,
                                                                               **kw)
        for i in range(8 if mode == "train" else 3):
            a, b = j[i], t[i]
            assert a.dtype == b.dtype == np.float32 and a.shape[:3] == (6, 32, 32)
            np.testing.assert_array_equal(b, a)
    j, t = jvd.VideoClipDataset(root, **kw), tvd.VideoClipDataset(root, **kw)
    for a, b in zip([next(j.iter_batches(2)) for _ in range(3)],
                    [next(t.iter_batches(2)) for _ in range(3)]):
        np.testing.assert_array_equal(b, a)
    aug = dict(kw, auto_augment="rand-m9-n2-mstd0.5", reprob=0.5, seed=11)
    j, t = jvd.VideoClipDataset(root, **aug), tvd.VideoClipDataset(root, **aug)
    assert t.rand_augment is not None and t.rand_erasing is not None  # applied to rgb only
    for i in range(12):
        a, b = j[i % 3], t[i % 3]
        np.testing.assert_array_equal(b, a)
        assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_divae_warm_start_matches_jax(tmp_path):
    """The central tubelet frame from the 2-D projection, the encoder
    blocks and quant_proj, from a .safetensors file read without the
    package.  JAX's version skips the blocks' LayerNorm weights (it asks
    for `scale`, its LayerNorm names them `weight`); the port copies them:
    every other tensor equals JAX's, those equal the file's."""
    from egom2p_tpu.compat.torch_convert import load_divae_encoder_warm_start as jax_warm

    rng = np.random.default_rng(5)
    dim, p = SMALL["dim"], SMALL["patch_size"]
    sd = {"encoder.proj.weight": rng.standard_normal((dim, 3, p, p)),
          "encoder.proj.bias": rng.standard_normal(dim),
          "quant_proj.weight": rng.standard_normal((D, dim, 1, 1)),
          "quant_proj.bias": rng.standard_normal(D),
          "encoder.norm_mlp.weight": rng.standard_normal(dim)}   # no target: skipped
    for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                        ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                        ("attn.proj.weight", (dim, dim)), ("norm2.bias", (dim,)),
                        ("mlp.fc1.weight", (4 * dim, dim)), ("mlp.fc2.weight", (dim, 4 * dim))):
        sd[f"encoder.blocks.0.{name}"] = rng.standard_normal(shape)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    from safetensors.numpy import save_file  # the test's writer; the port reads with no package
    path = str(tmp_path / "divae.safetensors")
    save_file(sd, path)
    jt = jvv.video_vqvae_from_config("rgb", jax.random.PRNGKey(0), **SMALL)
    tt = tvv.video_vqvae_from_config("rgb", **SMALL)
    tt.net.load_state_dict(video_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    j_params = jax_warm(path, jax.tree_util.tree_map(np.asarray, jt.params), verbose=False)
    copied, skipped = load_divae_encoder_warm_start(path, tt.net, verbose=False)
    want = video_vqvae_state_dict_from_jax(j_params, jt.vq_state, tt)
    got = tt.net.state_dict()
    ln = {"encoder.blocks.0.norm1.weight"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), sd[k] if k in ln else want[k].numpy(),
                                      err_msg=k)
    mid = got["encoder.patch_embed.weight"][:, :, 1].numpy()
    np.testing.assert_array_equal(mid, sd["encoder.proj.weight"])
    assert "encoder.norm_mlp.weight" in skipped and "encoder.blocks.0.norm2.weight" in skipped
    assert "quant_proj.weight" in copied and len(copied) == 2 + 8 + 2


def test_cli_rgb_train_resume_eval_tokenize(tmp_path):
    """python -m egom2p_torch.cli.run_training_vqvae --domain rgb on .npy
    clips: 2 epochs with eval and the EMA, a resumed third epoch, image
    logs, --eval_only and --tokenize (the tokens equal the trained
    tokenizer's)."""
    data = _write_clips(tmp_path / "vids", [(20, 32, 32)] * 4)
    out = str(tmp_path / "out")
    argv = ["--domain", "rgb", "--data_path", data, "--use_npy", "--num_frames", "4",
            "--input_size", "32", "--patch_size", "8", "--tubelet_size", "2",
            "--codebook_size", "64", "--latent_dim", "8", "--vq_dim", "48", "--vq_depth", "1",
            "--vq_heads", "4", "--batch_size", "2", "--epochs", "2", "--warmup_epochs", "0",
            "--model_ema", "true", "--output_dir", out, "--device", "cpu"]
    res = tcli.main(argv)
    assert len(res["metrics"]) == 4 and all(np.isfinite(m["loss"]) for m in res["metrics"])
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert "eval_mse" in log[-1] and "ema_mse" in log[-1] and "eval_psnr" in log[-1]
    logs = os.listdir(os.path.join(out, "image_logs"))
    assert "ep1_gt.npy" in logs and "ep1_recon.npy" in logs
    # the latest numbered checkpoint is epoch 0's (as the JAX trainer picks):
    # epochs 1 and 2 run again
    more = tcli.main(argv + ["--epochs", "3"])
    assert len(more["metrics"]) == 4 and more["optimizer"].step_count == 6
    ckpt = os.path.join(out, "checkpoint-final.pth")
    res_eval = tcli.main(argv + ["--eval_only", "--resume", ckpt, "--eval_data_path", data])
    assert {"eval_loss", "mse", "psnr", "codebook_usage"} <= set(res_eval)
    paths = tcli.main(argv + ["--tokenize", "--resume", ckpt, "--tokenize_path", data,
                              "--tokenize_save_path", str(tmp_path / "tok")])
    tokens = np.load(paths[0])["arr_0"]
    assert tokens.shape == (2, 4, 4) and tokens.dtype == np.int16
    clip = tvd.VideoClipDataset(data, mode="tokenize", clip_len=4, crop_size=32,
                                use_npy=True)[0][None]
    np.testing.assert_array_equal(tokens, more["tokenizer"].tokenize(clip).numpy()[0])


def test_cli_rgb_under_torchrun_equals_one_process(tmp_path):
    """Two CPU ranks of 2 clips against one process of 4, 2 epochs with the
    eval on the training clips between them: every rank draws the global
    batch and continues from rank 0's clip stream after its eval, so the
    logged losses and eval metrics equal one process's (the gradients'
    sum over the ranks in another order: 1e-5)."""
    import subprocess
    import sys

    data = _write_clips(tmp_path / "vids", [(20, 32, 32)] * 8)
    args = ["--domain", "rgb", "--data_path", data, "--use_npy", "--num_frames", "4",
            "--input_size", "32", "--patch_size", "8", "--vq_dim", "48", "--vq_depth", "1",
            "--vq_heads", "4", "--codebook_size", "64", "--latent_dim", "8", "--epochs", "2",
            "--warmup_epochs", "0", "--num_eval_metrics_samples", "2", "--async_save", "false",
            "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logs = []
    for launcher, batch, out in (([], "4", "one"),
                                 (["-m", "torch.distributed.run", "--standalone",
                                   "--nproc_per_node", "2"], "2", "two")):
        proc = subprocess.run([sys.executable, *launcher, "-m",
                               "egom2p_torch.cli.run_training_vqvae", *args, "--batch_size",
                               batch, "--output_dir", str(tmp_path / out)], cwd=root,
                              capture_output=True, text=True, timeout=150, env=env)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        logs.append([json.loads(line) for line in open(tmp_path / out / "log.txt")])
    one, two = logs
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        for key in ("loss", "reconst_loss", "code_loss", "eval_mse", "eval_codebook_usage"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, err_msg=key)
