"""data/prep.py against egom2p_tpu/data/prep.py: the readers, the cam /
gaze training-set builders and statistics, the eye-gaze projection and the
neighbour-clip windows, on the same seeded files.  Tolerance: none (both
are numpy over the same arithmetic; the port's data/cam_gaze.py is a copy
of the JAX module's)."""
import numpy as np
import pytest

import egom2p_tpu.data.prep as jp
from egom2p_torch.data import prep as tp


def _poses(rng, n):
    """Smooth camera poses (n, 4, 4): a random walk of small rotations."""
    out = np.tile(np.eye(4), (n, 1, 1))
    ang = np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    for i, (a, b, c) in enumerate(ang):
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        out[i, :3, :3] = rx @ ry @ rz
    out[:, :3, 3] = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    return out


def _write_pose_txt(path, poses):
    path.write_text("\n".join("\t".join(map(str, [i, i * 33] + list(p.reshape(-1))))
                              for i, p in enumerate(poses)) + "\n\nignored after the blank\n")


@pytest.mark.parametrize("convention", sorted(jp.CONVENTIONS))
def test_cam_training_set_matches_jax(tmp_path, convention):
    rng = np.random.default_rng(0)
    files = []
    for i, n in enumerate((95, 70, 130)):
        poses = _poses(rng, n)
        if i == 1:
            poses[30, 0, 0] = np.nan  # windows holding it are dropped
        if i == 2:
            f = tmp_path / f"clip_{i}.txt"
            _write_pose_txt(f, poses)
        else:
            f = tmp_path / f"clip_{i}.npy"
            np.save(f, poses)
        files.append(str(f))
    want = jp.build_cam_training_set(files, str(tmp_path / "j.npy"), convention)
    got = tp.build_cam_training_set(files, str(tmp_path / "t.npy"), convention)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    for a, b in zip(tp.compute_cam_stats(got), jp.compute_cam_stats(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp.read_pose_txt(files[2]), jp.read_pose_txt(files[2]))


def test_gaze_training_set_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    files = []
    for i, n in enumerate((80, 65)):
        g = np.stack([rng.uniform(0, 896, n), rng.uniform(0, 504, n)], 1)
        g[rng.uniform(size=n) < 0.1] = np.nan  # invalid samples
        f = tmp_path / f"g_{i}.npz"
        np.savez(f, g)
        files.append(str(f))
    kw = dict(orig_res=[896, 504], resize_res=[448, 252], new_res=(480, 480), stride=5)
    want = jp.build_gaze_training_set(files, str(tmp_path / "j.npy"), **kw)
    got = tp.build_gaze_training_set(files, str(tmp_path / "t.npy"), **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1:] == (60, 3)


def test_eye_gaze_projection_and_readers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    T = 40
    poses = _poses(rng, T)
    rows = np.concatenate([np.arange(T)[:, None], np.arange(T)[:, None] * 33,
                           rng.normal(0, 0.1, (T, 3)), rng.normal(0, 1, (T, 3)) + [0, 0, 2.0]], 1)
    (tmp_path / "Eyes_sync.txt").write_text(
        "\n".join("\t".join(map(str, r)) for r in rows) + "\n")
    K = np.array([[450.0, 0, 448], [0, 450.0, 252], [0, 0, 1]])
    (tmp_path / "Intrinsics.txt").write_text("\t".join(map(str, list(K.reshape(-1)) + [896.0,
                                                                                       504.0])))
    g_t = tp.read_gaze_txt(str(tmp_path / "Eyes_sync.txt"))
    np.testing.assert_array_equal(g_t, jp.read_gaze_txt(str(tmp_path / "Eyes_sync.txt")))
    k_t = tp.read_intrinsics_txt(str(tmp_path / "Intrinsics.txt"))
    k_j = jp.read_intrinsics_txt(str(tmp_path / "Intrinsics.txt"))
    np.testing.assert_array_equal(k_t[0], k_j[0])
    assert k_t[1:] == k_j[1:]
    for dist in (0.5, 1.3):
        np.testing.assert_array_equal(tp.project_eye_gaze(g_t, poses, k_t[0], dist),
                                      jp.project_eye_gaze(g_t, poses, k_j[0], dist))
        np.testing.assert_array_equal(tp.get_eye_gaze_point(g_t[3], dist),
                                      jp.get_eye_gaze_point(g_t[3], dist))
    np.testing.assert_array_equal(tp.AXIS_TRANSFORM, jp.AXIS_TRANSFORM)


def test_neighbor_windows_and_sorting_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    names = ["seq_a_10", "seq_a_2", "seq_a_3", "seq_b_4", "seq_a_11", "seq_a_5"]
    for n in names:
        data = rng.normal(0, 1, (45, 4, 4))
        if n == "seq_a_5":
            data[0, 0, 0] = np.nan
        np.save(tmp_path / f"{n}.npy", data)
    files = [str(tmp_path / f"{n}.npy") for n in names]
    assert sorted(files, key=tp.natural_sort_key) == sorted(files, key=jp.natural_sort_key)
    for stride in (5, 10):
        want = jp.concat_neighbor_windows(files, np.load, stride=stride)
        got = tp.concat_neighbor_windows(files, np.load, stride=stride)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tp.is_neighbor("x_a_1.npy", "x_a_2.npy") and not tp.is_neighbor("x_a_1.npy",
                                                                           "x_b_2.npy")
    seq = np.arange(100)
    for a, b in zip(tp.temporal_overlap_augmentation(seq, 7, 30),
                    jp.temporal_overlap_augmentation(seq, 7, 30)):
        np.testing.assert_array_equal(a, b)
