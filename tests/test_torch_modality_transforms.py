"""data/{resample,modality_transforms,folder_dataset,generation_datasets}.py
against the JAX package's modules.

The same seeds (Python `random`, numpy's global state) and the same inputs
go through both.  Tolerances, measured here:
  * resize: 8-bit images (bilinear, bicubic, lanczos, nearest) and
    float nearest / bicubic bitwise; float bilinear within one float32 ulp
    (3e-8 on values of 1) on under 0.5% of the pixels; 16-bit (depth PNGs)
    within one level on under 1% of the pixels (Pillow's 16-bit sums land
    on the other side of an exact half now and then), nearest bitwise;
  * every transform of default_modality_transforms(), of the DiVAE and
    VQ-ControlNet sets and UnifiedDataTransform: bitwise equal outputs
    (the 16-bit depth map through DepthTransform within 1e-5 after its
    standardization);
  * the SAM polygons: point_polygon_test equals cv2.pointPolygonTest on
    every point; fill_polygon equals cv2.fillPoly on every pixel of simple
    polygons inside the raster, and differs on at most 0.5% of the pixels
    cv2 sets where the polygon leaves the raster or crosses itself
    (measured 0.14-0.15%: cv2 fills the edges its clipping moved); the
    SAM instance masks on at most 1% (every SAM mask reaches the raster's
    far edge), their boxes and validity bitwise;
  * the folder and generation datasets: bitwise equal samples.
"""
import json
import random

import cv2
import numpy as np
import pytest
from PIL import Image

import egom2p_torch.data.modality_transforms as TT
import egom2p_tpu.data.modality_transforms as JT
from egom2p_torch.cli.tokenize_images import resize_image
from egom2p_torch.data import folder_dataset as tfd
from egom2p_torch.data import generation_datasets as tgd
from egom2p_torch.data.resample import resize
from egom2p_tpu.data import folder_dataset as jfd
from egom2p_tpu.data import generation_datasets as jgd

PIL_MODES = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "nearest": Image.NEAREST,
             "lanczos": Image.LANCZOS}


def assert_same(got, want, path="out", atol=0.0):
    """Recursive equality of transform outputs (dicts, lists, strings,
    arrays), arrays within `atol`."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype)
        if atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(dtype)
    if dtype == np.uint16:
        return rng.integers(0, 65536, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _pil_resize(a, size, mode):
    return np.asarray(Image.fromarray(a).resize(size[::-1], resample=PIL_MODES[mode]))


# lanczos serves tokenize_images' 8-bit images only
@pytest.mark.parametrize("shape,dtype,mode", [
    (shape, dtype, mode)
    for shape, dtype in (((37, 45, 3), np.uint8), ((37, 45), np.uint8), ((40, 33), np.uint16),
                         ((37, 45), np.float32))
    for mode in ("bilinear", "bicubic", "nearest", "lanczos")
    if mode != "lanczos" or dtype == np.uint8])
def test_resize_matches_pillow(shape, dtype, mode):
    a = _image(np.random.default_rng(0), shape, dtype)
    for size in [(24, 24), (80, 70), (37, 20), (224, 224), (11, 90)]:
        want, got = _pil_resize(a, size, mode), resize(a, size, mode)
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        if dtype == np.uint16 and mode != "nearest":
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (size, diff.max())
        elif dtype == np.float32 and mode == "bilinear":
            assert diff.max() <= 6e-8 and (diff > 0).mean() <= 5e-3, (size, diff.max())
        else:
            assert diff.max() == 0, (size, mode, diff.max(), (diff > 0).mean())


def test_tokenize_images_resize_is_pillows_lanczos():
    img = _image(np.random.default_rng(1), (100, 130, 3), np.uint8)
    for short in (24, 64, 300):
        h, w = img.shape[:2]
        want = np.asarray(Image.fromarray(img).resize(
            (int(round(w * short / h)), short), Image.LANCZOS))
        np.testing.assert_array_equal(resize_image(img, short), want)


@pytest.mark.parametrize("resample_mode", [None, "bicubic", "nearest"])
def test_crop_and_resize_matches_jax(resample_mode):
    rng = np.random.default_rng(2)
    for dtype, shape in ((np.uint8, (50, 60, 3)), (np.uint8, (50, 60)), (np.float32, (50, 60, 2)),
                         (np.float64, (50, 60))):
        img = _image(rng, shape, dtype)
        for crop in ((0, 0, 50, 60), (-5, 10, 40, 40), (20, 30, 60, 45)):
            want = JT.image_crop_and_resize(img, crop, (32, 24), resample_mode)
            got = TT.image_crop_and_resize(img, crop, (32, 24), resample_mode)
            atol = 6e-8 if dtype != np.uint8 and resample_mode is None else 0.0
            assert_same(got, want, f"{dtype.__name__}{shape}{crop}", atol)
    with pytest.raises(ValueError, match="not supported"):
        TT.image_crop_and_resize(img, (0, 0, 10, 10), 8, "box")


def _sample(rng, size=64):
    """One aligned sample of every modality default_modality_transforms()
    knows, with 2 stored crop settings."""
    s = size
    return {
        "rgb": rng.integers(0, 256, (s, s + 16, 3)).astype(np.uint8),
        "mask_valid": (rng.uniform(size=(s, s + 16)) > 0.2).astype(np.uint8) * 255,
        "tok_rgb": rng.integers(0, 100, (2, 16)),
        "tok_depth": rng.integers(0, 100, (2, 16)),
        "caption": ["a caption of crop 0", "a caption of crop 1"],
        "det": {"instances": [
            {"boxes": [0.1, 0.2, 0.5, 0.6], "class_name": "cat", "score": 0.9},
            {"boxes": [0.3, 0.1, 0.9, 0.4], "class_name": "dog", "score": 0.7},
            {"boxes": [0.0, 0.0, 0.1, 0.1], "class_name": "cup", "score": 0.2}]},
        "t5_caption": {"emb": rng.standard_normal((2, 6, 8)).astype(np.float32),
                       "mask_valid": np.array([[1, 1, 1, 0, 0, 0], [1, 1, 0, 0, 0, 0]])},
        "metadata": {"num_objects": 12, "is_indoor": True, "brightness": 0.37,
                     "walkability": 0.9},
        "human_poses": {
            "bbox_xyxy": [[10.0, 12.0, 40.0, 50.0], [5.0, 6.0, 20.0, 30.0]],
            "pred_smpl_params": {"global_orient": rng.uniform(-1, 1, (2, 3, 3)).tolist(),
                                 "betas": rng.uniform(-2, 2, (2, 10)).tolist()},
            "pose_tokenized": rng.integers(0, 1024, (2, 8)).tolist(),
            "pred_cam": rng.uniform(-2, 20, (2, 3)).tolist()},
        "color_palette": [{str(k): rng.integers(0, 256, (k, 3)).tolist() for k in range(1, 8)}],
        "sam_instance": np.array([{
            "points": [np.array([[[0, 0]], [[40, 0]], [[40, 40]], [[0, 40]]], np.float32)[None],
                       np.array([[[10, 10]], [[60, 12]], [[30, 63]]], np.float32)[None]],
            "token_ids": rng.integers(0, 1024, (2, 4)),
            "bbox": rng.uniform(0, 64, (2, 4))} for _ in range(2)], dtype=object),
        "crop_settings": np.array([[0, 0, s, s, 0], [4, 8, 48, 48, 1]]),
    }


def _copy(sample):
    import copy
    return copy.deepcopy(sample)


def _run(mod, make, sample, seed):
    """make(mod) -> a transform; its output on `sample` with Python's and
    numpy's global generators seeded, and the generators' states after."""
    random.seed(seed)
    np.random.seed(seed)
    out = make(mod)(_copy(sample))
    return out, (random.getstate(), np.random.get_state()[1].tolist())


def _both(make, sample, seed):
    want, jstate = _run(JT, make, sample, seed)
    got, tstate = _run(TT, make, sample, seed)
    assert tstate == jstate  # the same draws
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_transforms_pretokenized_pipeline(seed):
    """Every modality of default_modality_transforms() through
    UnifiedDataTransform with the pre-tokenized augmenter."""
    sample = _sample(np.random.default_rng(seed))
    assert set(sample) - {"crop_settings"} == set(TT.default_modality_transforms()) - {
        "tok_cam", "tok_gaze", "tok_normal", "tok_semseg", "tok_clip", "tok_canny_edge",
        "tok_sam_edge", "tok_dinov2", "tok_imagebind", "tok_dinov2_global",
        "tok_imagebind_global"}
    assert set(TT.default_modality_transforms()) == set(JT.default_modality_transforms())
    make = lambda m: m.UnifiedDataTransform(  # noqa: E731
        m.default_modality_transforms(),
        m.PreTokenizedImageAugmenter(target_size=32, no_aug=False, main_domain="rgb"),
        add_sizes=True)
    got, want = _both(make, sample, seed)
    assert_same(got, want)


@pytest.mark.parametrize("resample_mode", [None, "bicubic"])
@pytest.mark.parametrize("augmenter", ["random_crop", "center", "padding", "scale_jitter"])
def test_image_transforms_with_each_augmenter(augmenter, resample_mode):
    """rgb (with colour jitter), mask, detection, metadata, palette, pose
    and caption embeddings under each drawing augmenter; the DiVAE set's
    depth (uint16), normal and semseg maps too."""
    rng = np.random.default_rng(3)
    sample = {k: v for k, v in _sample(rng).items()
              if k in ("rgb", "mask_valid", "det", "metadata", "color_palette", "human_poses",
                       "t5_caption")}
    sample["caption"] = ["one", "two", "three"]
    div = {"rgb": sample["rgb"], "depth": rng.integers(0, 65536, (64, 80)).astype(np.uint16),
           "normal": rng.integers(0, 256, (64, 80, 3)).astype(np.uint8),
           "semseg_coco": rng.integers(0, 20, (64, 80)).astype(np.uint8),
           "mask_valid": sample["mask_valid"]}

    def augment(m):
        return {"random_crop": lambda: m.RandomCropImageAugmenter(target_size=(32, 40)),
                "center": lambda: m.CenterCropImageAugmenter(32, hflip=0.5),
                "padding": lambda: m.PaddingImageAugmenter(32, hflip=0.5),
                "scale_jitter": lambda: m.ScaleJitteringImageAugmenter(32, hflip=0.5)
                }[augmenter]()

    def make(m):
        tr = m.default_modality_transforms()
        tr["rgb"] = m.RGBTransform(imagenet_default_mean_and_std=True, color_jitter=True)
        tr["caption"] = m.CaptionTransform(aligned_captions=False)
        tr["metadata"] = m.MetadataTransform(shuffle=True, random_trunc=True)
        tr["det"] = m.DetectionTransform(det_threshold=0.5, det_max_instances=1,
                                         bbox_order="random")
        return m.UnifiedDataTransform(tr, augment(m), resample_mode=resample_mode)

    def make_div(m):
        tr = m.divae_modality_transforms()
        tr["semseg_coco"] = m.SemsegTransform(scale_factor=0.5, shift_idx_by_one=True,
                                              id_mapping={3: 7})
        tr["mask_valid"] = m.MaskTransform(mask_pool_size=3)
        return m.UnifiedDataTransform(tr, augment(m), resample_mode=resample_mode)

    for seed in (4, 5):
        got, want = _both(make, sample, seed)
        assert_same(got, want)
        got, want = _both(make_div, div, seed)
        depth_got, depth_want = got.pop("depth"), want.pop("depth")
        assert_same(got, want)
        np.testing.assert_allclose(depth_got, depth_want, rtol=0, atol=1e-5)
        got, want = _both(lambda m: m.UnifiedDataTransform(
            m.vqcontrolnet_modality_transforms(), augment(m)), {
                "rgb": sample["rgb"], "mask_valid": sample["mask_valid"],
                "caption": ["x", "y"]}, seed)
        assert_same(got, want)


def test_augmenters_and_identity_paths():
    rng = np.random.default_rng(6)
    md = {"rgb": rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)}
    for make in (lambda m: m.NoImageAugmenter(), lambda m: m.EmptyAugmenter(),
                 lambda m: m.RandomCropImageAugmenter(24, crop_ratio=(3.0, 4.0))):
        got, want = _both(lambda m: (lambda d: make(m)(d, None)), md, 7)
        assert got == want
    settings = np.array([[0, 0, 10, 10, 0], [1, 2, 8, 8, 1], [3, 3, 5, 5, 0]])
    got, want = _both(lambda m: (lambda d: m.PreTokenizedImageAugmenter(16)(d, settings)), md, 8)
    assert got == want
    with pytest.raises(ValueError, match="not used"):
        TT.RandomCropImageAugmenter()(md, settings)
    plain = TT.UnifiedDataTransform(TT.default_modality_transforms(), None, augment=False)
    assert_same(plain({"tok_rgb": [1, 2]}), {"tok_rgb": np.array([1, 2])})
    with pytest.raises(ValueError, match="missing"):
        TT.TokTransform().image_augment(np.ones((2, 3)), None, False, None, None, None)


def _polygons(rng, kind, n=60, size=64):
    """Star-shaped (simple) contours inside the raster or reaching out of
    it, or random vertices (crossing edges)."""
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 12))
        if kind == "crossing":
            pts = rng.uniform(-5, size + 5, (k, 2))
        else:
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(4, size * (0.5 if kind == "inside" else 0.8), k)
            pts = np.stack([size / 2 + r * np.cos(ang), size / 2 + r * np.sin(ang)], 1)
            if kind == "inside":
                pts = np.clip(pts, 0, size - 1)
        out.append(pts.astype(np.int32))
    return out


@pytest.mark.parametrize("kind", ["inside", "border", "crossing"])
def test_fill_polygon_against_cv2(kind):
    cv2_set = differ = 0
    for pts in _polygons(np.random.default_rng(9), kind):
        want = np.zeros((64, 64), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = TT.fill_polygon((64, 64), pts)
        cv2_set += int(want.sum())
        differ += int((got != want).sum())
    if kind == "inside":
        assert differ == 0
    else:
        assert differ <= 5e-3 * cv2_set, (differ, cv2_set)


def test_point_polygon_test_equals_cv2():
    rng = np.random.default_rng(10)
    for _ in range(200):
        c = rng.integers(0, 30, (int(rng.integers(3, 10)), 2)).astype(np.float32)
        for _ in range(15):
            p = (int(rng.integers(0, 30)), int(rng.integers(0, 30)))
            assert TT.point_polygon_test(c, p) == cv2.pointPolygonTest(
                c.reshape(-1, 1, 2), p, False)
    for p in ((0, 0), (32, 64), (10, 10), (70, 3)):  # corners, edges, inside, outside
        sq = np.array([[0, 0], [64, 0], [64, 64], [0, 64]], np.float32)
        assert TT.point_polygon_test(sq, p) == cv2.pointPolygonTest(sq.reshape(-1, 1, 2), p,
                                                                   False)


@pytest.mark.parametrize("flip", [False, True])
def test_sam_instance_transform_matches_jax(flip):
    """SAMInstanceTransform's masks (cv2.fillPoly in JAX), boxes and
    validity on simple contours."""
    rng = np.random.default_rng(11)
    sample = np.array([{"points": p[:, None, :] * 3} for p in _polygons(rng, "inside", n=8)],
                      dtype=object)

    def make(m):
        t = m.SAMInstanceTransform(mask_size=32, max_instance_n=6)

        def run(s):
            s = t.preprocess(s)
            s = t.image_augment(s, (10, 20, 150, 160), flip, (192, 192), (64, 64))
            return t.postprocess(s)
        return run

    got, want = _both(make, sample, 12)
    masks_got, masks_want = got.pop("instance"), want.pop("instance")
    assert_same(got, want)
    assert masks_got.shape == masks_want.shape and masks_got.dtype == masks_want.dtype
    assert (masks_got != masks_want).sum() <= 0.01 * masks_want.sum()


def _write_tree(root, rng, n_per_class=2):
    """root/{rgb,depth,tok_rgb,caption}/class_x/NAME.ext: PNG images
    (8-bit rgb, 16-bit depth), .npy tokens and .json captions."""
    for cls in ("class_a", "class_b"):
        for i in range(n_per_class):
            name = f"{cls}_{i}"
            for sub in ("rgb", "depth", "tok_rgb", "caption"):
                (root / sub / cls).mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)).save(
                root / "rgb" / cls / f"{name}.png")
            Image.fromarray(rng.integers(0, 65536, (40, 52)).astype(np.uint16)).save(
                root / "depth" / cls / f"{name}.png")
            np.save(root / "tok_rgb" / cls / f"{name}.npy", rng.integers(0, 99, (2, 16)))
            (root / "caption" / cls / f"{name}.json").write_text(
                json.dumps([f"{name} crop 0", f"{name} crop 1"]))


def test_folder_datasets_match_jax(tmp_path):
    _write_tree(tmp_path, np.random.default_rng(13))
    mods = ["rgb", "depth", "tok_rgb", "caption"]

    def make(m, fd, max_samples=None, pre_shuffle=False, transform=True):
        tr = m.default_modality_transforms()
        tr["depth"] = m.DepthTransform()
        # a random crop gives no crop index: the tokens go through untransformed
        udt = m.UnifiedDataTransform(tr, m.RandomCropImageAugmenter(24)) if transform else None
        ds = fd.MultiModalDatasetFolder(str(tmp_path), mods[:2] + mods[3:] if transform else mods,
                                        modality_transforms=tr,
                                        transform=udt, max_samples=max_samples,
                                        pre_shuffle=pre_shuffle, return_path=True)
        return lambda _: [ds[i] for i in range(len(ds))]

    for kw in ({}, {"max_samples": 3, "pre_shuffle": True}, {"transform": False}):
        want, _ = _run(JT, lambda m: make(m, jfd, **kw), None, 14)
        got, _ = _run(TT, lambda m: make(m, tfd, **kw), None, 14)
        for g, w in zip(got, want):
            depth_g, depth_w = g.pop("depth"), w.pop("depth")
            np.testing.assert_allclose(depth_g, depth_w, rtol=0, atol=1e-5)
            g.pop("crop_settings", None), w.pop("crop_settings", None)
            assert_same(g, w)
        assert len(got) == len(want)
    # the default loader (no transform for the modality): the same arrays
    j = jfd.MultiModalDatasetFolder(str(tmp_path), ["rgb", "tok_rgb", "caption"])
    t = tfd.MultiModalDatasetFolder(str(tmp_path), ["rgb", "tok_rgb", "caption"])
    assert_same(t[1], j[1])
    assert tfd.make_dataset(str(tmp_path / "rgb"), t.class_to_idx, tfd.IMG_EXTENSIONS) == \
        jfd.make_dataset(str(tmp_path / "rgb"), j.class_to_idx, jfd.IMG_EXTENSIONS)
    with pytest.raises(ValueError, match="exactly one"):
        tfd.make_dataset(str(tmp_path), {}, None, None)
    # flat directories of .npy / .npz
    for mod in ("a", "b"):
        (tmp_path / "flat" / mod).mkdir(parents=True)
        for k in range(3):
            np.save(tmp_path / "flat" / mod / f"k{k}.npy", np.full(4, k))
    dirs = {m: str(tmp_path / "flat" / m) for m in ("a", "b")}
    jf, tf = jfd.MultiModalFolderDataset(dirs), tfd.MultiModalFolderDataset(dirs)
    assert tf.keys == jf.keys and len(tf) == 3
    assert_same(list(tf.iter_epoch(np.random.default_rng(0))),
                list(jf.iter_epoch(np.random.default_rng(0))))


def test_npy_images_load_without_pillow(tmp_path):
    """An image modality stored as .npy loads through the same transform
    (the card's machine has no Pillow); a PNG of it gives the same pixels."""
    img = np.random.default_rng(15).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.save(tmp_path / "a.npy", img)
    Image.fromarray(img).save(tmp_path / "a.png")
    t = TT.RGBTransform()
    np.testing.assert_array_equal(t.load(str(tmp_path / "a.npy")), t.load(str(tmp_path / "a.png")))


class _Tokenizer:
    """The two calls PartiPromptsDataset makes of a text tokenizer."""

    def token_to_id(self, token):
        return {"[PAD]": 0, "[EOS]": 2}[token]

    def encode(self, text):
        class Enc:
            ids = [3 + len(w) for w in text.split()]
        return Enc()


def test_generation_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(16)
    for k in range(3):
        for sub in ("rgb", "caption"):
            (tmp_path / "ic" / sub).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (36, 48, 3)).astype(np.uint8)).save(
            tmp_path / "ic" / "rgb" / f"s{k}.png")
        (tmp_path / "ic" / "caption" / f"s{k}.txt").write_text(f"caption {k} " * (k + 1))
    root = str(tmp_path / "ic")
    got, want = _both(lambda m: (lambda _: [
        {"tgd": tgd, "jgd": jgd}["tgd" if m is TT else "jgd"].ImageCaptionDataset(
            root, m.CenterCropImageAugmenter(24, hflip=0.5))[i] for i in range(3)]), None, 17)
    assert_same(got, want)
    raw = tgd.ImageCaptionDataset(root)[0]
    assert_same(raw, jgd.ImageCaptionDataset(root)[0])
    assert len(tgd.EmptyDataset(5)) == 5 and tgd.EmptyDataset(5)[3] == {}
    tsv = tmp_path / "PartiPrompts.tsv"
    tsv.write_text("Prompt\tCategory\n" + "".join(
        f"{'a long prompt ' * (40 * (k % 2) + 1)}\tx\n" for k in range(4)))
    np.savez(tmp_path / "t5.npz", emb=rng.standard_normal((4, 5, 8)).astype(np.float32),
             mask_valid=rng.uniform(size=(4, 5)) > 0.3)
    kw = dict(max_length=16, parti_prompts_tsv=str(tsv), parti_prompts_t5_embs=str(tmp_path / "t5.npz"))
    j, t = jgd.PartiPromptsDataset(_Tokenizer(), **kw), tgd.PartiPromptsDataset(_Tokenizer(), **kw)
    assert len(t) == len(j) == 4
    for i in range(4):
        assert_same(t[i], j[i])
    with pytest.raises(FileNotFoundError, match="PartiPrompts"):
        tgd.PartiPromptsDataset(_Tokenizer(), parti_prompts_tsv=str(tmp_path / "missing.tsv"))
