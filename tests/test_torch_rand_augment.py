"""data/rand_augment.py against egom2p_tpu/data/rand_augment.py.

The JAX module computes every pixel with Pillow, frame by frame; the port
with torch on the whole clip.  Tolerance, measured here: none.  Every op
gives Pillow's bytes at both resamples (bilinear and bicubic), on noise and
on smooth frames, at several magnitudes and both signs; RandAugment and
RandomErasing take the JAX module's draws in its order (the generator's
state after a call is the same) and give its clips bitwise.
"""
import numpy as np
import pytest
import torch
from PIL import Image

import egom2p_torch.data.rand_augment as tra
import egom2p_tpu.data.rand_augment as jra
from egom2p_torch.data import video_dataset as tvd

RESAMPLES = {"bilinear": (jra._BILINEAR, tra.BILINEAR), "bicubic": (jra._BICUBIC, tra.BICUBIC)}
FILL = (124, 116, 103)


def _frames(seed, t=3, h=29, w=37):
    """Noise frames and smooth ones (gradients plus a little noise)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 7 + yy * 3 + 40 * c) % 256 for c in range(3)], -1)[None]
    smooth = np.clip(smooth + rng.normal(0, 4, (t, h, w, 3)), 0, 255).astype(np.uint8)
    low = (noise // 5 + 90).astype(np.uint8)  # a narrow histogram: autocontrast / equalize
    return [noise, smooth, low]


def _op_args(name):
    """Arguments of op `name` at magnitudes 0.5 .. 10, both signs."""
    class Draw:  # _randomly_negate negates on a draw above 0.5
        def __init__(self, value):
            self.value = value

        def random(self):
            return self.value

    out = []
    fn = jra.LEVEL_TO_ARG[name]
    for level in (0.5, 3.0, 7.3, 10.0):
        for sign in (0.3, 0.7):
            out.append(fn(level, {"translate_const": 13, "translate_pct": 0.45}, Draw(sign))
                       if fn is not None else ())
    return sorted(set(out))


@pytest.mark.parametrize("resample", sorted(RESAMPLES))
@pytest.mark.parametrize("name", sorted(jra.NAME_TO_OP))
def test_op_matches_jax_bitwise(name, resample):
    j_rs, t_rs = RESAMPLES[resample]
    for frames in _frames(1):
        for args in _op_args(name):
            want = np.stack([np.asarray(jra.NAME_TO_OP[name](
                Image.fromarray(f), *args, fillcolor=FILL, resample=j_rs)) for f in frames])
            got = tra.NAME_TO_OP[name](torch.from_numpy(frames), *args, fillcolor=FILL,
                                       resample=t_rs).numpy()
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name}{args}")


def test_level_maps_and_tables_are_the_jax_modules():
    assert list(tra.LEVEL_TO_ARG) == list(jra.LEVEL_TO_ARG)
    assert tra._RAND_TRANSFORMS == jra._RAND_TRANSFORMS
    assert tra._RAND_INCREASING_TRANSFORMS == jra._RAND_INCREASING_TRANSFORMS
    assert tra._RAND_CHOICE_WEIGHTS_0 == jra._RAND_CHOICE_WEIGHTS_0
    hp = {"translate_const": 100}
    for name, fn in tra.LEVEL_TO_ARG.items():
        if fn is None:
            continue
        for level in (0.0, 2.5, 9.0, 10.0):
            a, b = np.random.default_rng(2), np.random.default_rng(2)
            assert fn(level, hp, a) == jra.LEVEL_TO_ARG[name](level, hp, b)
            assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("spec", ["rand-m9-n2-mstd0.5", "rand-m7-n2-w0",
                                  "rand-m10-n3-mstd1.0-inc1"])
@pytest.mark.parametrize("interpolation", ["bilinear", "random"])
def test_randaugment_draws_and_clips_match_jax(spec, interpolation):
    """create_random_augment on a clip and a single frame, several calls:
    the same draws (the generator's state after each call) and bytes."""
    jaug = jra.create_random_augment(32, spec, interpolation)
    taug = tra.create_random_augment(32, spec, interpolation)
    assert [o.name for o in taug.ops] == [o.name for o in jaug.ops]
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    clip = _frames(5, t=4, h=32, w=32)[1]
    for call in range(8):
        x = clip if call % 3 else clip[0]
        want, got = jaug(x, jr), taug(x, tr)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert tr.bit_generator.state == jr.bit_generator.state


def test_config_strings_and_refusals():
    assert tra.rand_augment_transform("rand-m5-n4").num_layers == 4
    with pytest.raises(ValueError, match="unsupported augment spec"):
        tra.rand_augment_transform("augmix-m5")
    with pytest.raises(ValueError, match="unknown RandAugment key"):
        tra.rand_augment_transform("rand-m5-z3")
    with pytest.raises(ValueError, match="weight set 0"):
        tra.rand_augment_transform("rand-w1")
    with pytest.raises(NotImplementedError, match="RandAugment"):
        tra.create_random_augment(32, "augmix-m5-w0")
    assert tra.create_random_augment(32, None) is None
    with pytest.raises(ValueError, match="uint8"):
        tra.RandAugment(tra.rand_augment_ops())(np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
@pytest.mark.parametrize("cube,counts", [(True, (1, None)), (False, (1, 3)), (True, (2, 4))])
def test_random_erasing_matches_jax(mode, cube, counts):
    rng = np.random.default_rng(6)
    clip = rng.uniform(-1, 1, (6, 24, 20, 3)).astype(np.float32)
    kw = dict(probability=0.8, mode=mode, min_count=counts[0], max_count=counts[1],
              num_splits=2, cube=cube)
    j, t = jra.RandomErasing(**kw), tra.RandomErasing(**kw)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for x in (clip, clip[0], clip):
        np.testing.assert_array_equal(t(x, tr), j(x, jr))
        assert tr.bit_generator.state == jr.bit_generator.state


def test_video_batch_loader_workers(tmp_path):
    """VideoBatchLoader's forked workers: worker w's batches are the
    in-process stream of the dataset reseeded with seed + 1000 (w + 1)."""
    rng = np.random.default_rng(8)
    for i in range(3):
        np.save(tmp_path / f"c{i}.npy", rng.integers(0, 256, (20, 24, 24, 3), dtype=np.uint8))
    kw = dict(clip_len=4, crop_size=24, frame_sample_rate=2, use_npy=True,
              auto_augment="rand-m9-n2-mstd0.5", reprob=0.25)
    loader = tvd.VideoBatchLoader(tvd.VideoClipDataset(str(tmp_path), **kw), batch_size=2,
                                  seed=5, num_workers=1)
    it = iter(loader)
    try:
        got = [next(it) for _ in range(3)]
    finally:
        it.close()
    assert all(not p.is_alive() for p in it.workers)
    ref = tvd.VideoClipDataset(str(tmp_path), seed=5 + 1000, **kw)
    stream = ref.iter_batches(2)
    for g in got:
        np.testing.assert_array_equal(g, next(stream))
    with pytest.raises(ValueError, match="forks workers"):
        tvd.VideoBatchLoader(ref, 2, num_workers=0)
