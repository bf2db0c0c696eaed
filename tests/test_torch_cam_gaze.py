"""The port's numpy host modules for cam and gaze (data/cam_gaze.py,
core/metrics.py) and the cam / gaze artifact decoders (generate/decode.py)
against the JAX package's, on seeded inputs.

The host modules are copies: their outputs are equal.  The .npy artifacts
go through each package's VQ-VAE decoder (same weights, fp32): within
DECODE_ATOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import egom2p_tpu.core.metrics as jmetrics
import egom2p_tpu.data.cam_gaze as jcg
from egom2p_torch.core import metrics as tmetrics
from egom2p_torch.data import cam_gaze as tcg
from egom2p_torch.generate import decode as tdecode
from egom2p_tpu.generate import decode as jdecode

from test_torch_seq_vqvae import DECODE_ATOL, pair


def _poses(rng, n=60):
    """Random rigid poses (n, 4, 4): rotations by QR, translations normal."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = q
    out[:, :3, 3] = rng.standard_normal((n, 3))
    return out


def test_constants_are_the_jax_packages():
    for name in ("CAM_MEAN", "CAM_STD", "GAZE_MEAN", "GAZE_STD", "CW90",
                 "OPENGL_TO_OPENCV", "HOLOCAM_TO_OPENCV"):
        np.testing.assert_array_equal(getattr(tcg, name), getattr(jcg, name), err_msg=name)
    assert tcg.calculate_ate.__doc__ == jcg.calculate_ate.__doc__  # the parity quirk stays


def test_cam_functions_match_jax():
    rng = np.random.default_rng(0)
    poses = _poses(rng)
    nine = jcg.canonicalize_cam(poses)
    np.testing.assert_array_equal(tcg.canonicalize_cam(poses), nine)
    np.testing.assert_array_equal(tcg.normalize_cam(nine), jcg.normalize_cam(nine))
    np.testing.assert_array_equal(tcg.denormalize_cam(nine), jcg.denormalize_cam(nine))
    np.testing.assert_array_equal(tcg.cam_9d_to_mat(nine), jcg.cam_9d_to_mat(nine))
    np.testing.assert_array_equal(tcg.cam_9d_to_mat(nine.reshape(-1)),
                                  jcg.cam_9d_to_mat(nine.reshape(-1)))
    pred = nine + 0.05 * rng.standard_normal(nine.shape)
    for delta in (1, 3):
        assert tcg.evaluate_9d_trajectory(pred, nine, delta) == \
            jcg.evaluate_9d_trajectory(pred, nine, delta)
    a, b = tcg.cam_9d_to_mat(pred), tcg.cam_9d_to_mat(nine)
    assert tcg.calculate_ate(a, b) == jcg.calculate_ate(a, b)
    assert tcg.calculate_rpe(a, b, 2) == jcg.calculate_rpe(a, b, 2)
    same = tcg.evaluate_9d_trajectory(nine, nine)
    assert same == jcg.evaluate_9d_trajectory(nine, nine) and same["ATE"] < 1e-12


def test_convert_gaze_matches_jax():
    rng = np.random.default_rng(1)
    gaze = rng.uniform(0, 900, (60, 2))
    gaze[3] = np.nan
    gaze[7, 0] = 5000.0   # far right of the frame
    gaze[9, 1] = -400.0   # far above it
    for res in (([896, 504], [896, 504], [480, 480]), ([1408, 1408], [480, 480], (480, 480))):
        t, j = tcg.convert_gaze(gaze.copy(), *res), jcg.convert_gaze(gaze.copy(), *res)
        np.testing.assert_array_equal(t, j)
        assert t.shape == (60, 3) and t[3, 2] == 0 and t[7, 2] == 0 and t[9, 2] == 0
    np.testing.assert_array_equal(tcg.denormalize_gaze(t[:, :2]), jcg.denormalize_gaze(t[:, :2]))


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), -1, 1)
    for fn in ("mse", "mae", "psnr", "ssim"):
        assert getattr(tmetrics, fn)(a, b) == getattr(jmetrics, fn)(a, b), fn
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    img = rng.uniform(-1, 1, (2, 24, 24, 3))
    assert tmetrics.ssim(img, img * 0.9) == jmetrics.ssim(img, img * 0.9)
    tokens = rng.integers(0, 256, (4, 30))
    for window in (None, 16, 1000):
        assert tmetrics.codebook_usage(tokens, 256, window) == \
            jmetrics.codebook_usage(tokens, 256, window)
    nine = tcg.smooth_cam_trajectories(rng, 2)[0].astype(np.float64)
    pred = nine + 0.05 * rng.standard_normal(nine.shape)
    assert tmetrics.rotation_distance_deg(pred, nine) == \
        jmetrics.rotation_distance_deg(pred, nine)
    xy, txy = rng.uniform(size=(60, 2)), rng.uniform(size=(60, 2))
    valid = rng.uniform(size=60) > 0.3
    assert tmetrics.masked_gaze_mse(xy, txy, valid) == jmetrics.masked_gaze_mse(xy, txy, valid)
    assert tmetrics.masked_gaze_mse(xy, txy, np.zeros(60)) == 0.0


@pytest.mark.parametrize("key,domain", [("tok_cam", "cam"), ("tok_gaze", "gaze")])
def test_decoded_npy_matches_jax_decode_targets(tmp_path, key, domain):
    """The same generated tokens through both packages' decode_targets:
    {name}/{file}_{key}.npy of the first clip, (60, 9) or (60, 2)."""
    jt, tt = pair(domain)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 30)).astype(np.int32)
    mod_dict = {key: {"tensor": tokens}}
    tout = tdecode.decode_targets("clip.npz", mod_dict, {key: tt}, [key],
                                  name=str(tmp_path / "torch"))
    jout = jdecode.decode_targets("clip.npz", mod_dict, {key: jt}, [key],
                                  name=str(tmp_path / "jax"))
    assert tout[key] == str(tmp_path / "torch" / f"clip.npz_{key}.npy")
    t, j = np.load(tout[key]), np.load(jout[key])
    assert t.shape == j.shape == ((60, 9) if domain == "cam" else (60, 2))
    assert t.dtype == j.dtype == np.float64
    np.testing.assert_allclose(t, j, atol=DECODE_ATOL, rtol=0)
    # the array half: every clip of the batch, de-standardised
    half = (tdecode.decode_cam_tokens if domain == "cam" else tdecode.decode_gaze_tokens)(tokens, tt)
    assert half.shape == (2,) + t.shape
    np.testing.assert_array_equal(half[0], t)
    raw = np.asarray(jt.decode_tokens(jnp.asarray(tokens)))[1]
    mean, std = (jcg.CAM_MEAN, jcg.CAM_STD) if domain == "cam" else (jcg.GAZE_MEAN, jcg.GAZE_STD)
    np.testing.assert_allclose(half[1], raw * std + mean, atol=DECODE_ATOL, rtol=0)
