"""The frozen feature teachers, the feature VQ-VAE and the feature-domain
CLI on the port against the JAX package, on the CPU at small widths.

* Every spec of TEACHER_SPECS at a small width (1 block; heads of 64 as in
  CLIP / DINOv2, of 80 as in ImageBind), its own image size and patch:
  dense and global outputs against JAX's with the weights carried by
  compat/from_jax.py.  Forced dense (the flash64 and stock routes patched
  off) the port computes JAX's CPU einsum path in fp32 (FP32_TOL of the
  output's largest magnitude); on its default route 257 tokens of heads of
  64 take the flash64_train forward and heads of 80 the stock route, whose
  plain versions round q / k / v and p to bf16 (BF16_TOL).
* The bilinear resize of an input of another size, up and down (torch's
  antialiased interpolate against jax.image.resize: RESIZE_TOL).
* The published torch layouts (CLIP, DINOv2 plain and fused SwiGLU,
  ImageBind) written by the test and read by load_teacher_pth: the weights
  bitwise the JAX converter's, the DINOv2 posemb interpolated from a
  pretrain grid by the same scipy bicubic.
* The feature VQ-VAE: tokenize / decode and one train step (loss,
  gradients, the EMA codebook) against JAX's, dense grid and 1 x 1 global.
* The CLI's --domain CLIP-B16 (the registry entry cut to a small width):
  2 epochs with eval and the EMA, a resume, --eval_only and --tokenize
  (tests/test_teachers.py:334's run).
"""
import dataclasses
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
from egom2p_torch.compat.from_jax import (feature_vqvae_state_dict_from_jax,
                                          teacher_state_dict_from_jax)
from egom2p_torch.models import teachers as tteach
from egom2p_torch.tokenizers import feature_vqvae as tfv
from egom2p_torch.train.vqvae_train import reconst_loss
from egom2p_tpu.compat import torch_convert as jconv
from egom2p_tpu.models import teachers as jteach
from egom2p_tpu.tokenizers import feature_vqvae as jfv
from egom2p_tpu.train.vqvae_train import init_train_state, make_vqvae_train_step

torch.set_num_threads(2)

FP32_TOL = 5e-5    # fp32 sums in another order (2.0e-5 seen, ImageBind's width 160)
BF16_TOL = 2e-2    # bf16 q / k / v and p in the attention's plain versions, 1 block
RESIZE_TOL = 3e-5  # torch's antialiased bilinear against jax.image.resize, in [-1, 1]
                   # (1.5e-5 seen: the taps' fp32 sums in another order)


def small(domain):
    """`domain`'s spec at 1 block and a small width: heads of the
    family's width (CLIP / DINOv2 64, ImageBind 80), 2 of them."""
    spec = jteach.TEACHER_SPECS[domain]
    hd = spec.width // spec.heads
    width = 2 * hd
    feat = 64 if spec.proj else width
    return dataclasses.replace(spec, width=width, depth=1, heads=2, feat_dim=feat)


@pytest.fixture(params=["dense", "kernels"])
def route(request, monkeypatch):
    calls = {"n": 0}
    if request.param == "dense":
        monkeypatch.setattr(port_transformer, "_try_flash64", lambda *a: None)
        monkeypatch.setattr(port_fa, "kernel_head_dim", lambda hd: None)
    else:
        for mod, name in ((port_f64t, "flash64_train_attention"),
                          (port_fa, "padding_flash_attention")):
            real = getattr(mod, name)

            def spy(*a, _real=real, **kw):
                calls["n"] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return request.param, calls


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of its max (limit {tol})"
    return err


def _pair(spec, seed=0):
    jm = jteach.ViTTeacher(spec)
    x0 = jnp.zeros((1, spec.image_size, spec.image_size, 3), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x0)
    tm = tteach.ViTTeacher(spec)
    tm.load_state_dict(teacher_state_dict_from_jax(params, tm))
    return jm, params, tm.eval()


@pytest.mark.parametrize("domain", list(jteach.TEACHER_SPECS))
def test_every_teacher_matches_jax(domain, route):
    kind, calls = route
    spec = small(domain)
    assert dataclasses.asdict(tteach.TEACHER_SPECS[domain]) == dataclasses.asdict(
        jteach.TEACHER_SPECS[domain])
    jm, params, tm = _pair(spec)
    x = np.random.default_rng(1).uniform(-1, 1, (2, spec.image_size, spec.image_size, 3)
                                         ).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    grid = 1 if spec.global_pool else spec.grid
    assert got.shape == want.shape == (2, grid, grid, spec.feat_dim)
    tokens = 1 + spec.grid ** 2
    kernel = tokens ** 2 >= 256 * 256  # 197 (CLIP-B16) stays dense
    _close(got, want, FP32_TOL if kind == "dense" or not kernel else BF16_TOL, domain)
    assert calls["n"] == (1 if kind == "kernels" and kernel else 0)


@pytest.mark.parametrize("size", [160, 256])
def test_teacher_resize_matches_jax(size, monkeypatch):
    monkeypatch.setattr(port_transformer, "_try_flash64", lambda *a: None)
    monkeypatch.setattr(port_fa, "kernel_head_dim", lambda hd: None)
    from egom2p_torch.core.image_ops import resize_bilinear
    x = np.random.default_rng(2).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    _close(resize_bilinear(torch.from_numpy(x), 224).numpy(),
           np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bilinear")),
           RESIZE_TOL, "resize")
    spec = small("CLIP-B16")
    jm, params, tm = _pair(spec)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jm.apply(params, jnp.asarray(x))), 1e-4, "teacher on a resized input")


def _published(family, spec, rng, grid0=None):
    """A random state dict in the published torch layout of `family`."""
    w, p, L = spec.width, spec.patch, spec.depth
    n_pos = 1 + (grid0 or spec.grid) ** 2
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    sd = {}
    if family == "clip":
        sd.update({"visual.conv1.weight": r(w, 3, p, p), "visual.class_embedding": r(w),
                   "visual.positional_embedding": r(n_pos, w), "visual.proj": r(w, spec.feat_dim)})
        for n in ("ln_pre", "ln_post"):
            sd[f"visual.{n}.weight"], sd[f"visual.{n}.bias"] = r(w), r(w)
        for i in range(L):
            b = f"visual.transformer.resblocks.{i}."
            sd.update({b + "ln_1.weight": r(w), b + "ln_1.bias": r(w), b + "ln_2.weight": r(w),
                       b + "ln_2.bias": r(w), b + "attn.in_proj_weight": r(3 * w, w),
                       b + "attn.in_proj_bias": r(3 * w), b + "attn.out_proj.weight": r(w, w),
                       b + "attn.out_proj.bias": r(w), b + "mlp.c_fc.weight": r(4 * w, w),
                       b + "mlp.c_fc.bias": r(4 * w), b + "mlp.c_proj.weight": r(w, 4 * w),
                       b + "mlp.c_proj.bias": r(w)})
        sd["text_projection"] = r(4, 4)  # a text tower's key: ignored
    elif family.startswith("dino"):
        sd.update({"patch_embed.proj.weight": r(w, 3, p, p), "patch_embed.proj.bias": r(w),
                   "cls_token": r(1, 1, w), "pos_embed": r(1, n_pos, w),
                   "norm.weight": r(w), "norm.bias": r(w)})
        for i in range(L):
            b = f"blocks.{i}."
            for n in ("norm1", "norm2"):
                sd[b + f"{n}.weight"], sd[b + f"{n}.bias"] = r(w), r(w)
            sd.update({b + "attn.qkv.weight": r(3 * w, w), b + "attn.qkv.bias": r(3 * w),
                       b + "attn.proj.weight": r(w, w), b + "attn.proj.bias": r(w),
                       b + "ls1.gamma": r(w), b + "ls2.gamma": r(w)})
            if family == "dino":
                sd.update({b + "mlp.fc1.weight": r(4 * w, w), b + "mlp.fc1.bias": r(4 * w),
                           b + "mlp.fc2.weight": r(w, 4 * w), b + "mlp.fc2.bias": r(w)})
            else:
                h = int(2 * 4 * w / 3)
                sd.update({b + "mlp.w12.weight": r(2 * h, w), b + "mlp.w12.bias": r(2 * h),
                           b + "mlp.w3.weight": r(w, h), b + "mlp.w3.bias": r(w)})
    else:
        pv, tv = "modality_preprocessors.vision.", "modality_trunks.vision."
        sd.update({pv + "rgbt_stem.proj.1.weight": r(w, 3, 2, p, p), pv + "cls_token": r(1, 1, w),
                   pv + "pos_embedding_helper.pos_embed": r(1, n_pos, w),
                   tv + "pre_transformer_layer.0.weight": r(w),
                   tv + "pre_transformer_layer.0.bias": r(w)})
        for i in range(L):
            b = f"{tv}blocks.{i}."
            for n in ("norm_1", "norm_2"):
                sd[b + f"{n}.weight"], sd[b + f"{n}.bias"] = r(w), r(w)
            sd.update({b + "attn.in_proj_weight": r(3 * w, w), b + "attn.in_proj_bias": r(3 * w),
                       b + "attn.out_proj.weight": r(w, w), b + "attn.out_proj.bias": r(w),
                       b + "mlp.fc1.weight": r(4 * w, w), b + "mlp.fc1.bias": r(4 * w),
                       b + "mlp.fc2.weight": r(w, 4 * w), b + "mlp.fc2.bias": r(w)})
        sd["modality_heads.vision.0.weight"] = r(4)  # a head's key: ignored
    return sd


@pytest.mark.parametrize("family,domain,grid0", [
    ("clip", "CLIP-B16", None), ("dino", "DINOv2-B14", 5), ("dino_swiglu", "DINOv2-G14-global", 5),
    ("imagebind", "ImageBind-H14", None)])
def test_loader_reads_published_layouts_as_jax(family, domain, grid0, tmp_path, monkeypatch):
    """load_teacher_pth against the JAX converter on a file the test writes:
    every weight bitwise (DINOv2's 1 + 5^2 pretrain posemb interpolated to
    the spec's grid by the same scipy code), and the outputs (dense)."""
    monkeypatch.setattr(port_transformer, "_try_flash64", lambda *a: None)
    monkeypatch.setattr(port_fa, "kernel_head_dim", lambda hd: None)
    spec = dataclasses.replace(small(domain), image_size=4 * small(domain).patch)
    monkeypatch.setitem(jteach.TEACHER_SPECS, domain, spec)
    monkeypatch.setitem(tteach.TEACHER_SPECS, domain, spec)
    sd = _published(family, spec, np.random.default_rng(3), grid0)
    path = str(tmp_path / "teacher.pth")
    torch.save(sd, path)
    j_params = jconv.load_teacher_pth(path, domain)
    tm = tteach.load_teacher_pth(path, domain, device="cpu")
    want = teacher_state_dict_from_jax(j_params, tteach.ViTTeacher(spec))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    if grid0:
        np.testing.assert_array_equal(
            tm.pos_embed.detach().numpy(),
            tteach.interp_posemb(sd["pos_embed"].numpy(), 1 + spec.grid ** 2))
    x = np.random.default_rng(4).uniform(-1, 1, (2, spec.image_size, spec.image_size, 3)
                                         ).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jteach.ViTTeacher(spec).apply(j_params, jnp.asarray(x))),
           FP32_TOL, domain)


FEAT = dict(codebook_size=16, latent_dim=8, dim=64, depth=1, num_heads=2)


@pytest.mark.parametrize("domain", ["DINOv2-B14", "DINOv2-B14-global"])
def test_feature_vqvae_round_trip_and_step_match_jax(domain, monkeypatch):
    """A 4 x 4 grid of 32-wide features (and the 1 x 1 global map):
    tokens and decode, then, on the grid, one train step's losses,
    gradients and codebook (dead codes expiring, JAX's draws) against
    JAX's."""
    spec = dataclasses.replace(jteach.TEACHER_SPECS[domain], width=32, feat_dim=32,
                               image_size=56)
    monkeypatch.setitem(jteach.TEACHER_SPECS, domain, spec)
    monkeypatch.setitem(tteach.TEACHER_SPECS, domain, spec)
    jt = jfv.feature_vqvae_from_config(domain, jax.random.PRNGKey(0), **FEAT)
    tt = tfv.feature_vqvae_from_config(domain, **FEAT)
    tt.net.load_state_dict(feature_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    grid = 1 if spec.global_pool else 4
    x = np.random.default_rng(5).standard_normal((4, grid, grid, 32)).astype(np.float32)
    j_tok = np.asarray(jt.tokenize(jnp.asarray(x)))
    np.testing.assert_array_equal(tt.tokenize(x).numpy(), j_tok)
    _close(tt.decode_tokens(torch.from_numpy(j_tok.copy())).numpy(),
           np.asarray(jt.decode_tokens(jnp.asarray(j_tok))), FP32_TOL, "decode")
    if spec.global_pool:
        return
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
    key = jax.random.PRNGKey(6)
    state, metrics = make_vqvae_train_step(jt.module, jt.vq_cfg, keep)(
        init_train_state(jt.params, keep, jt.vq_state), jnp.asarray(x), key)
    n_lat = 4 * grid * grid
    idx = torch.from_numpy(np.array(jax.random.randint(key, (16,), 0, n_lat)))
    pred, commit, _ = tt.net.train().autoencode_train(torch.from_numpy(x), replace_idx=idx)
    rec = reconst_loss(pred, torch.from_numpy(x), "mse", 32)
    (rec + commit).backward()
    np.testing.assert_allclose(rec.item(), float(metrics["reconst_loss"]), rtol=FP32_TOL)
    np.testing.assert_allclose(commit.item(), float(metrics["code_loss"]), rtol=FP32_TOL)
    want = feature_vqvae_state_dict_from_jax(state.opt_state, state.vq_state, tt)
    for name, p in tt.net.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-4, name)
    for name in ("embed", "cluster_size"):
        _close(getattr(tt.net.quantize.state, name).numpy(),
               np.asarray(getattr(state.vq_state, name)), FP32_TOL, name)


def test_cli_clip_b16_train_resume_eval_tokenize(tmp_path, monkeypatch):
    """--domain CLIP-B16 with its registry entry at a small width: images
    through the frozen teacher (fp32), 2 epochs with eval and the EMA, a
    resume, --eval_only, --tokenize (tokens equal the trained tokenizer's
    on the teacher's features)."""
    spec = tteach.TeacherSpec(name="CLIP-B16", patch=8, width=32, depth=1, heads=2, feat_dim=16,
                              proj=True, ln_pre=True, patch_bias=False, image_size=16)
    monkeypatch.setitem(tteach.TEACHER_SPECS, "CLIP-B16", spec)
    imgs = np.random.default_rng(0).integers(0, 255, (8, 20, 20, 3), dtype=np.uint8)
    data = str(tmp_path / "imgs.npy")
    np.save(data, imgs)
    out = str(tmp_path / "out")
    argv = ["--domain", "CLIP-B16", "--data_path", data, "--epochs", "2", "--batch_size", "4",
            "--vq_dim", "32", "--vq_depth", "1", "--vq_heads", "2", "--latent_dim", "8",
            "--codebook_size", "32", "--model_ema", "true", "--teacher_dtype", "fp32",
            "--num_eval_metrics_samples", "8", "--output_dir", out, "--device", "cpu"]
    res = tcli.main(argv)
    assert len(res["metrics"]) == 4
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert {"eval_mse", "eval_psnr", "ema_mse", "eval_codebook_usage"} <= set(log[-1])
    more = tcli.main(argv + ["--epochs", "3"])
    assert more["optimizer"].step_count == 6
    ckpt = os.path.join(out, "checkpoint-final.pth")
    ev = tcli.main(argv + ["--eval_only", "--resume", ckpt])
    assert {"eval_loss", "mse", "mae", "psnr", "codebook_usage"} == set(ev) - {"eval_reconst_loss"}
    path = tcli.main(argv + ["--tokenize", "--resume", ckpt, "--tokenize_path", data,
                             "--tokenize_save_path", str(tmp_path / "tok")])
    tokens = np.load(path)["arr_0"]
    assert tokens.shape == (8, 2, 2) and tokens.dtype == np.int16
    feat_fn, _ = tcli.build_teacher(tcli.get_args(argv), torch.device("cpu"))
    feats = feat_fn(imgs.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(tokens, more["tokenizer"].tokenize(feats).numpy())
