"""The image metrics of the tokenizer evaluation on the port against the JAX
package, on the CPU with seeded random network weights (no published
weights are in the repository):

* ms_ssim, frechet_distance / fid_from_features / FIDAccumulator,
  inception_score_from_probs and lpips_from_features: the JAX module's
  numpy math, equal to 1e-12;
* vgg16_features and the differentiable perceptual loss against JAX's
  (loss and its gradient) on seeded lpips_vgg.npz weights: NET_TOL of a
  tensor's largest magnitude (fp32 convolutions in another order);
* inception_v3_forward, both variants, against JAX's on seeded weights
  with the published shapes (tests/test_inception.py's), with its 299 x
  299 resize (antialiased when it shrinks): NET_TOL;
* the EGOM2P_CKPT_DIR lookup (read when a metric is built), the missing
  file's MissingPretrainedWeights, get_lpips / get_inception_fns, and the
  rgb eval suite's LPIPS / FID / IS keys when the files are there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.core import image_metrics as TM
from egom2p_torch.core import inception_v3 as tinc
from egom2p_torch.core import metrics as tmetrics
from egom2p_torch.core import vgg_features as tvgg
from egom2p_tpu.core import image_metrics as JM
from egom2p_tpu.core import inception_v3 as jinc
from egom2p_tpu.core import vgg_features as jvgg
from tests.test_inception import _random_weights

torch.set_num_threads(2)

NET_TOL = 1e-4   # of each tensor's largest magnitude


def vgg_weights(seed=0):
    return tvgg.random_weights(np.random.default_rng(seed))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of its max (limit {tol})"


def test_numpy_metrics_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 176, 176, 3))
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1)
    assert abs(TM.ms_ssim(a, b) - JM.ms_ssim(a, b)) < 1e-12
    fa, fb = rng.standard_normal((40, 8)), rng.standard_normal((40, 8)) + 0.5
    assert abs(TM.fid_from_features(fa, fb) - JM.fid_from_features(fa, fb)) < 1e-9
    acc = TM.FIDAccumulator(lambda x: x)
    acc.update(fa, real=True)
    acc.update(fb, real=False)
    assert acc.compute() == TM.fid_from_features(fa, fb)
    # the Frechet distance of two Gaussians in closed form (1-D)
    np.testing.assert_allclose(TM.frechet_distance(0.0, 4.0, 1.0, 1.0), 1 + 4 + 1 - 4)
    p = rng.dirichlet(np.ones(10), 50)
    assert abs(TM.inception_score_from_probs(p) - JM.inception_score_from_probs(p)) < 1e-12
    feats = [rng.standard_normal((2, 4, 4, c)) for c in (8, 16)]
    feats_b = [f + rng.normal(0, 0.3, f.shape) for f in feats]
    lins = [rng.uniform(0, 1, 8), rng.uniform(0, 1, 16)]
    for lw in (None, lins):
        assert abs(TM.lpips_from_features(feats, feats_b, lw)
                   - JM.lpips_from_features(feats, feats_b, lw)) < 1e-12
    reg = TM.register_default_perceptual_metrics(device="cpu")
    assert reg is tmetrics.PERCEPTUAL_METRICS and {"ms_ssim", "lpips"} <= set(reg)


def test_vgg_features_and_perceptual_loss_match_jax(tmp_path, monkeypatch):
    w = vgg_weights()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    for got, want in zip(tvgg.vgg16_features(x, w, device="cpu"), jvgg.vgg16_features(x, w)):
        _close(got, want, NET_TOL, "vgg tap")
    depth = x[..., :1][None]  # (1, 2, H, W, 1) clip of one channel
    for got, want in zip(tvgg.vgg16_features(depth, w, device="cpu"), jvgg.vgg16_features(depth, w)):
        _close(got, want, NET_TOL, "vgg tap, one channel")
    np.savez(tmp_path / "lpips_vgg.npz", **w)
    with pytest.raises(TM.MissingPretrainedWeights, match="lpips_vgg.npz"):
        TM.get_lpips(device="cpu")
    monkeypatch.setenv("EGOM2P_CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(JM, "_CKPT_DIR", str(tmp_path))
    np.testing.assert_allclose(TM.get_lpips(device="cpu")(x, y), JM.get_lpips()(x, y), rtol=NET_TOL)
    assert TM.get_lpips(device="cpu") is TM.get_lpips(device="cpu")  # built once per file and device
    import jax
    j_loss, j_grad = jax.value_and_grad(JM.make_perceptual_loss())(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_loss = TM.make_perceptual_loss(device="cpu")(xt, torch.from_numpy(y))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=NET_TOL)
    _close(xt.grad.numpy(), np.asarray(j_grad), NET_TOL, "perceptual loss gradient")


def test_random_weights_have_the_published_shapes():
    """The port's seeded weights (what chip_smoke.py writes) have the keys
    and shapes of tests/test_inception.py's published-shape table."""
    for n in (1000, 1008):
        want = _random_weights(np.random.default_rng(0), n)
        got = tinc.random_weights(np.random.default_rng(0), n)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("n_classes,size", [(1000, 64), (1008, 320)])
def test_inception_matches_jax(n_classes, size):
    """Both graphs, from a 64 x 64 input (resized up to 299) and a 320 x
    320 one (resized down, antialiased)."""
    rng = np.random.default_rng(2)
    w = _random_weights(rng, n_classes=n_classes)
    assert tinc.detect_variant(w) == jinc.detect_variant(w)
    imgs = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    j_f, j_l = jinc.inception_v3_forward(imgs, w)
    with torch.no_grad():
        t_f, t_l = tinc.inception_v3_forward(torch.from_numpy(imgs), tinc.to_device(w, "cpu"))
    _close(t_f.numpy(), np.asarray(j_f), NET_TOL, "pool3 features")
    _close(t_l.numpy(), np.asarray(j_l), NET_TOL, "logits")
    feature_fn, probs_fn, run = tinc.make_inception_fns(w, batch=1, device="cpu")
    np.testing.assert_array_equal(feature_fn(imgs), run(imgs)[0])
    np.testing.assert_allclose(probs_fn(imgs).sum(1), 1.0, rtol=1e-5)


def test_rgb_eval_suite_with_weight_files(tmp_path, monkeypatch):
    """The rgb metric suite of train/vqvae_eval.py on a small random video
    tokenizer: MSE / MAE / PSNR and codebook usage always; LPIPS, FID and
    the Inception score once their files are in EGOM2P_CKPT_DIR; MS-SSIM
    at a side of 176 or more."""
    from egom2p_torch.tokenizers.video_vqvae import video_vqvae_from_config
    from egom2p_torch.train.vqvae_eval import eval_metrics

    tok = video_vqvae_from_config("rgb", torch.Generator().manual_seed(0), num_frames=2,
                                  image_size=32, tubelet_t=2, patch_size=8, codebook_size=16,
                                  latent_dim=8, dim=48, depth=1, num_heads=4)
    data = np.random.default_rng(3).uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    monkeypatch.setenv("EGOM2P_CKPT_DIR", str(tmp_path))
    m = eval_metrics(tok, data, "rgb", 16, batch_size=2)
    assert set(m) == {"mse", "mae", "psnr", "codebook_usage"}
    np.savez(tmp_path / "lpips_vgg.npz", **vgg_weights())
    np.savez(tmp_path / "inception_v3.npz", **tinc.random_weights(np.random.default_rng(4)))
    m = eval_metrics(tok, data, "rgb", 16, batch_size=2)
    assert {"lpips", "fid", "inception_score"} <= set(m)
    assert all(np.isfinite(v) for v in m.values()) and m["inception_score"] >= 1.0
