"""The tools that make the training shards, on the port, on the CPU:

* python -m egom2p_torch.cli.run_training_vqvae at a small width (dim 64,
  2 + 2 blocks, 2 heads, latent 8, 16 codes): 2 epochs with eval and the
  EMA, its checkpoints, an auto-resume, --eval_only, and --tokenize /
  --recon, whose tokens are JAX's SeqTokenizer.tokenize on the same
  checkpoint (a differing token must be a near-tie: the top-2 cosine gap
  of the JAX latents under TIE_GAP; the count is printed);
* python -m egom2p_torch.cli.tokenize_videos against the root script
  tokenize_videos.py on a tar shard of seeded mp4 clips (and a broken one
  both skip) at --size 64 and the small Cosmos topology, on one set of
  weights: the same output tars, member for member, each member's array
  file bitwise (the zip's timestamps aside);
* the whole chain: the port's tokenize_videos for rgb and depth, its
  --tokenize for cam and gaze, the `-tok` rename, prepare_aligned_shards.py
  as a subprocess, then 2 steps of cli/run_training --data_config.
"""
import io
import json
import os
import pathlib
import subprocess
import sys
import tarfile
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.tokenizers.seq_vqvae as jseq
from egom2p_torch.cli import eval_common, run_training, run_training_vqvae, tokenize_videos
from egom2p_torch.compat.from_jax import cosmos_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_pth, load_seq_vqvae_pth, save_seq_vqvae_pth
from egom2p_torch.data.cam_gaze import smooth_cam_trajectories, smooth_gaze_tracks
from egom2p_torch.data.video_ingest import write_video
from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
from egom2p_torch.tokenizers.cosmos.network import DiscreteVideoConfig as TorchCfg
from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer
from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config
from egom2p_tpu.compat import torch_convert
from egom2p_tpu.ops import vq as jvq
from egom2p_tpu.tokenizers.cosmos import CausalVideoTokenizer as JaxTokenizer
from egom2p_tpu.tokenizers.cosmos.network import DiscreteVideoConfig as JaxCfg

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_ARGS = ["--vq_dim", "64", "--vq_depth", "2", "--vq_heads", "2", "--latent_dim", "8",
              "--codebook_size", "16"]
SMALL_SEQ = dict(dim=64, depth=2, num_heads=2, latent_dim=8, codebook_size=16)
COSMOS_SMALL = dict(channels=16, channels_mult=(1, 2, 2), z_channels=8)
TIE_GAP = 1e-5
TINY = "egom2p_tiny_6e_6d_swiglu_nobias"


def cam_paths(rng, n):
    """n canonical 9D camera paths (n, 60, 9), as a cam .npy holds them."""
    return smooth_cam_trajectories(rng, n)[1].astype(np.float32)


def vqvae_argv(domain, data, out, *more):
    return ["--domain", domain, "--data_path", str(data), "--output_dir", str(out),
            "--device", "cpu", *SMALL_ARGS, "--batch_size", "8", "--print_freq", "1",
            "--loss_fn", "mse" if domain == "cam" else "mse_mask", *more]


def jax_tokens_and_clear(path, domain, x):
    """JAX's tokens of `x` on the checkpoint at `path` (its loader at SMALL
    width) and the positions clear of a near-tie."""
    orig = jseq.seq_vqvae_from_config
    try:
        jseq.seq_vqvae_from_config = lambda d, rng, **kw: orig(d, rng, **{**kw, **SMALL_SEQ})
        jt = torch_convert.load_seq_vqvae_pth(path, domain)
    finally:
        jseq.seq_vqvae_from_config = orig
    lat = jt.module.apply(jt.params, jnp.asarray(x), method=jseq.SeqAutoencoder.encode_latents)
    sims = np.sort(np.asarray(jvq.l2norm(lat) @ jvq.l2norm(jt.vq_state.embed).T), axis=-1)
    return np.asarray(jt.tokenize(jnp.asarray(x))), sims[..., -1] - sims[..., -2] > TIE_GAP


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_vqvae_cli_trains_resumes_evaluates_and_tokenizes(domain, tmp_path, capsys):
    rng = np.random.default_rng(0)
    data = cam_paths(rng, 24) if domain == "cam" else smooth_gaze_tracks(rng, 24)
    np.save(tmp_path / "train.npy", data)
    out = tmp_path / "out"
    argv = vqvae_argv(domain, tmp_path / "train.npy", out, "--epochs", "2",
                      "--warmup_epochs", "1", "--model_ema", "true", "--model_ema_decay", "0.9",
                      "--num_eval_metrics_samples", "16")
    res = run_training_vqvae.main(argv)
    printed = capsys.readouterr().out  # the periodic save on its thread, the final one blocking
    assert f"saved (async) {out}/checkpoint-0.pth" in printed and \
        f"saved {out}/checkpoint-final.pth" in printed
    metrics = res["metrics"]
    assert len(metrics) == 6 and all(np.isfinite(v) for m in metrics for v in m.values())
    assert sorted(os.listdir(out)) == ["checkpoint-0.pth", "checkpoint-final.pth", "log.txt"]
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    keys = {"cam": ("eval_mse", "eval_cam_rot_deg"), "gaze": ("eval_mse", "eval_psnr")}[domain]
    for r in records:
        for k in ("loss", "reconst_loss", "code_loss", "codebook_usage", "eval_loss",
                  "eval_codebook_usage", "ema_mse", *keys):
            assert np.isfinite(r[k]), k
    final = load_pth(str(out / "checkpoint-final.pth"))
    assert (final["step"], final["epoch"]) == (6, 1) and final["args"].domain == domain
    assert set(final) >= {"model", "optimizer", "model_ema"}
    tok = load_seq_vqvae_pth(str(out / "checkpoint-final.pth"), domain, **SMALL_SEQ)
    for k, v in res["tokenizer"].net.state_dict().items():
        assert torch.equal(tok.net.state_dict()[k], v), k
    assert not torch.equal(final["model_ema"]["decoder.out_proj.weight"],
                           final["model"]["decoder.out_proj.weight"])

    # a checkpoint without an EMA seeds it from the loaded weights; one with
    # an EMA gives its own (--epochs 2 from step 6: no step runs)
    for keep_ema in (False, True):
        other = tmp_path / f"resume_{keep_ema}"
        other.mkdir()
        ckpt = dict(final) if keep_ema else {k: v for k, v in final.items() if k != "model_ema"}
        torch.save(ckpt, other / "checkpoint-final.pth")
        argv_other = argv[:argv.index("--output_dir") + 1] + [str(other)] + \
            argv[argv.index("--output_dir") + 2:]
        resumed = run_training_vqvae.main(argv_other)
        assert resumed["metrics"] == []
        want = final["model_ema"] if keep_ema else final["model"]
        for k, v in resumed["ema"].items():
            assert torch.equal(v, want[k]), k

    # auto-resume: the latest numbered checkpoint (epoch 0, step 3) over final
    capsys.readouterr()
    res = run_training_vqvae.main(argv[:argv.index("--epochs") + 1] + ["3"]
                                  + argv[argv.index("--epochs") + 2:])
    assert f"resumed from {out}/checkpoint-0.pth at step 3" in capsys.readouterr().out
    assert len(res["metrics"]) == 6
    assert load_pth(str(out / "checkpoint-final.pth"))["step"] == 9

    # --eval_only on the final checkpoint
    results = run_training_vqvae.main(argv + ["--eval_only", "--eval_data_path",
                                              str(tmp_path / "train.npy")])
    assert json.loads((out / "eval_results.json").read_text()) == results
    assert results.keys() >= {"eval_loss", "mse", "codebook_usage"}

    # --tokenize / --recon, against JAX's tokenizer on the same checkpoint
    ckpt = str(out / "checkpoint-final.pth")
    np.save(tmp_path / "clips.npy", data[:12])
    common = vqvae_argv(domain, tmp_path / "train.npy", out, "--tokenize", "--resume", ckpt,
                        "--tokenize_path", str(tmp_path / "clips.npy"),
                        "--tokenize_save_path", str(tmp_path))
    path = run_training_vqvae.main(common)
    assert path == str(tmp_path / "token" / "clips-tok.npz")
    tokens = np.load(path)["arr_0"]
    assert tokens.shape == (12, 30) and tokens.dtype == np.int16
    x, _ = run_training_vqvae.prepare_samples(run_training_vqvae.get_args(common),
                                              str(tmp_path / "clips.npy"))
    ref, clear = jax_tokens_and_clear(ckpt, domain, x)
    differ = tokens != ref
    print(f"{domain}: {int(differ.sum())} of {tokens.size} tokens differ from JAX's, "
          f"{int((~clear).sum())} positions within {TIE_GAP} of a tie")
    assert not (differ & clear).any()
    rec_path = run_training_vqvae.main(common + ["--recon"])
    rec = np.load(rec_path)
    assert rec_path.endswith("clips-recon.npy")
    assert rec.shape == (12, 60, 9 if domain == "cam" else 2) and np.isfinite(rec).all()


def test_vqvae_cli_refuses_what_is_not_ported(tmp_path):
    np.save(tmp_path / "d.npy", smooth_gaze_tracks(np.random.default_rng(0), 8))
    base = vqvae_argv("gaze", tmp_path / "d.npy", tmp_path / "o")
    for extra, match in ((["--domain", "rgb"], "item 9"), (["--quantizer_type", "taming"],
                                                           "item 9"),
                         (["--encoder_ckpt", "divae.safetensors"], "item 9")):
        with pytest.raises(NotImplementedError, match=match):
            run_training_vqvae.main(base + extra)
    (tmp_path / "orbax").mkdir()
    for mode in (["--tokenize", "--tokenize_path", str(tmp_path / "d.npy")], ["--eval_only"]):
        with pytest.raises(ValueError, match="orbax"):
            run_training_vqvae.main(base + mode + ["--resume", str(tmp_path / "orbax")])
    if not torch.cuda.is_available():  # --device defaults to cuda: no CPU fallback
        argv = [a for a in base if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training_vqvae.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tokenize_videos.main(["--input", str(tmp_path), "--output-dir", str(tmp_path),
                                  "--smoke"])
    with pytest.raises(FileNotFoundError, match="Cosmos checkpoint"):
        tokenize_videos.main(["--input", str(tmp_path), "--output-dir", str(tmp_path),
                              "--device", "cpu", "--video-tok-ckpt", str(tmp_path / "no.jit")])


def _clips_shard(path, rng, n=2, size=(20, 80, 96)):
    """A tar shard of n seeded mp4 clips (key clip_i) and a broken one."""
    tmp = path.parent / "mp4"
    tmp.mkdir(exist_ok=True)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            f = tmp / f"clip_{i}.mp4"
            write_video(str(f), rng.integers(0, 256, (*size, 3), dtype=np.uint8))
            tar.add(f, arcname=f"clip_{i}.mp4")
        bad = tmp / "broken.mp4"
        bad.write_bytes(b"not an mp4")
        tar.add(bad, arcname="broken.mp4")


def _members(path):
    """[(name, the npz's arr_0.npy bytes)] of an output tar, in order."""
    with tarfile.open(path) as tar:
        return [(m.name, zipfile.ZipFile(io.BytesIO(tar.extractfile(m).read())).read("arr_0.npy"))
                for m in tar]


def test_tokenize_videos_tars_equal_the_jax_scripts(tmp_path, monkeypatch):
    import egom2p_tpu.core.cache as jax_cache
    import tokenize_videos as jax_script
    shards = tmp_path / "in"
    shards.mkdir()
    rng = np.random.default_rng(1)
    for s in range(2):
        _clips_shard(shards / f"shard-{s:03d}.tar", rng)
    jtok = JaxTokenizer.random_init(jax.random.PRNGKey(0), JaxCfg(**COSMOS_SMALL), frames=9,
                                    size=64)
    net = CausalDiscreteVideoTokenizer(TorchCfg(**COSMOS_SMALL))
    net.load_state_dict(cosmos_state_dict_from_jax(jtok.params, net))
    common = ["--input", f"{shards}/shard-{{000..001}}.tar", "--size", "64", "--batch", "3",
              "--smoke"]
    monkeypatch.setattr(JaxTokenizer, "random_init", classmethod(lambda cls, key: jtok))
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["tokenize_videos.py", *common, "--output-dir",
                                      str(tmp_path / "jax")])
    jax_script.main()
    monkeypatch.setattr(tokenize_videos, "load_tokenizer",
                        lambda args, device: CausalVideoTokenizer(net))
    counts = tokenize_videos.main([*common, "--output-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert counts == {"shard-000.tar": 2, "shard-001.tar": 2}
    for name in counts:
        port, ref = _members(tmp_path / "port" / name), _members(tmp_path / "jax" / name)
        assert [n for n, _ in port] == [n for n, _ in ref] == ["clip_0.npz", "clip_1.npz"]
        for (_, a), (_, b) in zip(port, ref):
            assert a == b
        arr = np.load(io.BytesIO(a))
        assert arr.shape == (5, 8, 8) and arr.dtype == np.int32


def test_tokenizers_to_aligned_shards_to_pretraining(tmp_path, monkeypatch):
    """Raw clips and trajectories -> port tokens -> prepare_aligned_shards.py
    -> 2 pretraining steps of the tiny model, with finite losses."""
    rng = np.random.default_rng(2)
    keys = [f"ego_{i}" for i in range(4)]
    monkeypatch.setattr(eval_common, "COSMOS_CONFIG", TorchCfg(**COSMOS_SMALL))
    mods = {}
    for mod in ("rgb", "depth"):
        clips = tmp_path / f"{mod}_mp4"
        clips.mkdir()
        for k in keys:
            write_video(str(clips / f"{k}.mp4"), rng.integers(0, 256, (16, 256, 256, 3),
                                                             dtype=np.uint8))
        tokenize_videos.main(["--input", str(clips), "--output-dir", str(tmp_path / mod),
                              "--smoke", "--device", "cpu"])
        mods[mod] = tmp_path / f"{mod}_npz"
        with tarfile.open(tmp_path / mod / "shard-000000.tar") as tar:
            tar.extractall(mods[mod], filter="data")
    for domain in ("cam", "gaze"):
        raw = tmp_path / f"{domain}_raw"
        raw.mkdir()
        # cam: canonical 9D paths; gaze: pixel coordinates of a 896 x 504 frame
        data = (cam_paths(rng, 4) if domain == "cam"
                else rng.uniform(0, 1, (4, 60, 2)) * [896, 504])
        for k, d in zip(keys, data):
            np.save(raw / f"{k}.npy", d)
        ckpt = save_seq_vqvae_pth(seq_vqvae_from_config(domain, torch.Generator().manual_seed(3),
                                                        **SMALL_SEQ),
                                  str(tmp_path / f"{domain}.pth"))
        outs = [run_training_vqvae.main(
            vqvae_argv(domain, raw, tmp_path, "--tokenize", "--resume", ckpt,
                       "--tokenize_path", str(raw / f"{k}.npy"), "--tokenize_save_path",
                       str(tmp_path / domain))) for k in keys]
        # the user's rename: <key>-tok.npz -> <key>.npz, to align with the video tokens
        mods[domain] = tmp_path / domain / "token"
        for path in outs:
            os.rename(path, path.replace("-tok.npz", ".npz"))
    shards = tmp_path / "shards"
    proc = subprocess.run([sys.executable, str(REPO / "prepare_aligned_shards.py"),
                           *(f"--modality={m}={d}" for m, d in mods.items()),
                           "--output-dir", str(shards), "--shard-size", "4"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "aligned keys: 4" in proc.stdout
    import yaml
    alphas = yaml.safe_load((REPO / "cfgs" / "alphas" / "mod4_uniform.yaml").read_text())
    (tmp_path / "alphas.json").write_text(json.dumps(alphas))
    domains = "tok_rgb-tok_depth-tok_cam-tok_gaze"
    cfg = {"train": {"datasets": {"ego": {
        "type": "multimodal", "in_domains": domains, "out_domains": domains,
        "input_alphas": None, "target_alphas": None,
        "alphas_config": str(tmp_path / "alphas.json"),
        "data_path": f"{shards}/[rgb,depth,cam,gaze]/shard-{{000000..000000}}.tar",
        "wds_n_repeats": 2, "wds_shuffle_buffer_tar": 4}}, "weights": [1.0]}}
    (tmp_path / "data.json").write_text(json.dumps(cfg))
    steps = []
    run_training.main(run_training.get_args([
        "--data_config", str(tmp_path / "data.json"), "--model", TINY, "--batch_size", "2",
        "--num_input_tokens", "32", "--num_target_tokens", "32", "--epochs", "1",
        "--epoch_size", "4", "--eval_freq", "0", "--device", "cpu", "--output_dir",
        str(tmp_path / "pretrain")]), on_step=lambda step, m, s: steps.append(m))
    assert len(steps) == 2
    assert all(np.isfinite(v) for m in steps for v in m.values())
