"""The port's rgb2cam and rgb2gaze entry points (python -m
egom2p_torch.cli.eval_model_rgb2cam / eval_model_rgb2gaze) on the CPU, end
to end with --smoke --device cpu: seeded npz files of 5120 rgb tokens ->
ROAR with CFG on the tiny registry model (3 and 5 steps) -> the cam / gaze
VQ-VAE decoder (at dim 128, depth 2, swapped in through
eval_common.SEQ_CONFIG) -> a (60, 9) / (60, 2) .npy per file.

In a file of its own: each run pushes the encoder's 5120-token attention
through the plain version on the CPU (about a minute).
"""
import numpy as np
import pytest
import torch

from egom2p_torch.cli import eval_common, eval_model_rgb2cam, eval_model_rgb2gaze

from test_torch_seq_vqvae import SMALL

torch.set_num_threads(2)

TINY = "egom2p_tiny_6e_6d_swiglu_nobias"


@pytest.mark.parametrize("entry,task,key,shape", [
    (eval_model_rgb2cam, "rgb2cam", "tok_cam", (60, 9)),
    (eval_model_rgb2gaze, "rgb2gaze", "tok_gaze", (60, 2))], ids=["rgb2cam", "rgb2gaze"])
def test_entry_point_writes_the_trajectory(tmp_path, monkeypatch, entry, task, key, shape):
    monkeypatch.setattr(eval_common, "SEQ_CONFIG", SMALL)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    np.savez(data / f"{task}_0.npz", rng.integers(0, 64000, (5, 32, 32)))
    np.savez(data / "rgb2dep_0.npz", rng.integers(0, 64000, (5, 32, 32)))  # another task's
    records = entry.main(["--smoke", "--device", "cpu", "--model", TINY, "--data", str(data),
                          "--out", str(tmp_path / "out")])
    assert [r["file"] for r in records] == [f"{task}_0.npz"]
    rec = records[0]
    assert rec["generate_s"] > 0 and rec["decode_s"] > 0 and rec["tokenize_s"] >= 0
    path = rec["outputs"][key]
    assert path == f"{tmp_path}/out/{task}/{task}_0.npz_{key}.npy"
    out = np.load(path)
    assert out.shape == shape and out.dtype == np.float64 and np.isfinite(out).all()
    assert out.std() > 0
