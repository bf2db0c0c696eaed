"""The port's eval entry points (python -m egom2p_torch.cli.eval_model_rgb2depth
and eval_model_depth2rgb) on the CPU, end to end: a seeded 16 x 256 x 256 mp4
written with the port's write_video -> Cosmos tokens -> ROAR with CFG on the
tiny registry model -> Cosmos decode -> a 16-frame mp4.

The tokenizer is the small topology of tests/test_torch_cosmos_decode.py,
swapped in through eval_common.COSMOS_CONFIG: at DV4x8x8's width the encode
and decode take minutes on the CPU (the `slow` test runs it).  The token
grid is the full 5 x 32 x 32 either way.
"""
import numpy as np
import pytest
import torch

from egom2p_torch.cli import eval_common, eval_model_depth2rgb, eval_model_rgb2depth
from egom2p_torch.data.video_ingest import read_video, write_video
from egom2p_torch.tokenizers.cosmos.network import DV4x8x8_CONFIG, DiscreteVideoConfig

torch.set_num_threads(2)

SMALL = DiscreteVideoConfig(channels=16, channels_mult=(1, 2, 2), z_channels=8)
TINY = "egom2p_tiny_6e_6d_swiglu_nobias"


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name in ("rgb2dep_0.mp4", "dep2rgb_0.mp4"):
        write_video(str(d / name), rng.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8))
    return d


@pytest.fixture
def small_tokenizer(monkeypatch):
    monkeypatch.setattr(eval_common, "COSMOS_CONFIG", SMALL)


def _args(clips, out, *more):
    return ["--smoke", "--device", "cpu", "--model", TINY, "--data", str(clips),
            "--out", str(out), *more]


@pytest.mark.parametrize("entry,task,target", [
    (eval_model_rgb2depth, "rgb2depth", "tok_depth"),
    (eval_model_depth2rgb, "depth2rgb", "tok_rgb"),
])
def test_entry_point_writes_the_target_mp4(clips, tmp_path, small_tokenizer, entry, task, target):
    records = entry.main(_args(clips, tmp_path))
    assert len(records) == 1
    rec = records[0]
    assert rec["file"] == ("rgb2dep_0.mp4" if task == "rgb2depth" else "dep2rgb_0.mp4")
    assert all(rec[k] > 0 for k in ("tokenize_s", "generate_s", "decode_s"))
    path = rec["outputs"][target]
    assert path == f"{tmp_path}/{task}/{rec['file']}_{target}.mp4"
    video = read_video(path)
    assert video.shape == (16, 256, 256, 3) and video.dtype == np.uint8
    assert video.std() > 0
    gray = (video[..., 0] == video[..., 1]).all() and (video[..., 0] == video[..., 2]).all()
    assert gray == (target == "tok_depth")


def test_entry_point_runs_on_the_card_or_raises(clips, tmp_path):
    """--device defaults to cuda: with no CUDA device the entry point raises
    and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_model_rgb2depth.main(["--smoke", "--model", TINY, "--data", str(clips),
                                   "--out", str(tmp_path)])


def test_missing_checkpoints_raise_without_smoke(clips, tmp_path):
    """No fallback to random weights: a missing --ckpt or --video-tok-ckpt
    raises."""
    common = ["--device", "cpu", "--data", str(clips), "--out", str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="EgoM2P checkpoint"):
        eval_model_rgb2depth.main(common + ["--ckpt", str(tmp_path / "none.pth")])
    with pytest.raises(FileNotFoundError, match="no inputs matching"):
        eval_model_depth2rgb.main(["--smoke", "--device", "cpu", "--data", str(tmp_path),
                                   "--out", str(tmp_path)])


@pytest.mark.slow
def test_rgb2depth_at_the_full_tokenizer_width(clips, tmp_path):
    assert eval_common.COSMOS_CONFIG == DV4x8x8_CONFIG
    records = eval_model_rgb2depth.main(_args(clips, tmp_path))
    video = read_video(records[0]["outputs"]["tok_depth"])
    assert video.shape == (16, 256, 256, 3) and (video[..., 0] == video[..., 1]).all()
