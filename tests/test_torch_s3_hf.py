"""S3 shards and checkpoint sync, and local Hugging Face datasets, on the
port, with no boto3 and no network.

S3 runs through a dict-backed fake client (the four botocore calls the
port makes: get_object, upload_file, download_file and a paginated
list_objects_v2, two keys a page), as tests/test_s3_sync.py does for the
JAX package: the data/s3_utils.py helpers, core/s3_sync.py's upload,
listing, download and resume assist, an s3:// shard read through
data/tar_reader.py against the same tar read locally, and the trainer with
--s3_save_dir (save, upload, the local copy wiped, the newest checkpoint
downloaded, the run resumed) and s3:// data shards.  Without a client and
without boto3 each raises, naming boto3.

Hugging Face: a dataset written by `datasets`' save_to_disk gives the same
samples in the same order through the port's huggingface_samples as
through the JAX package's (no shuffle buffer and a seeded one, a Dataset
and a DatasetDict split), and trains through the trainer's setup_data
(type: huggingface); without the package the port raises, naming it.
"""
import io
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

import egom2p_torch.data.s3_utils as s3_utils
from egom2p_torch.cli import run_training
from egom2p_torch.core import s3_sync
from egom2p_torch.core.checkpoint import latest_checkpoint, load_pth, save_checkpoint
from egom2p_torch.data import tar_reader
from egom2p_torch.data.modality_info import make_scaled_modality_info
from egom2p_torch.models.egom2p import create_model
from test_torch_data_shards import per_mod_paths, shard_args, write_tree

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")

torch.set_num_threads(2)


class FakeS3:
    """A dict-backed stand-in for a boto3 S3 client; listings come in pages
    of two keys."""

    def __init__(self):
        self.store = {}

    def upload_file(self, filename, bucket, key):
        with open(filename, "rb") as f:
            self.store[(bucket, key)] = f.read()

    def download_file(self, bucket, key, filename, **kw):
        with open(filename, "wb") as f:
            f.write(self.store[(bucket, key)])

    def get_object(self, Bucket, Key):
        return {"Body": io.BytesIO(self.store[(Bucket, Key)])}

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        keys = sorted(k for (b, k) in self.store if b == Bucket and k.startswith(Prefix))
        start = int(ContinuationToken) if ContinuationToken else 0
        page = keys[start:start + 2]
        truncated = start + 2 < len(keys)
        resp = {"Contents": [{"Key": k} for k in page], "IsTruncated": truncated}
        if truncated:
            resp["NextContinuationToken"] = str(start + 2)
        return resp

    def put_tree(self, root, bucket):
        """Every file under `root` as bucket/<its path under root>."""
        for path in pathlib.Path(root).rglob("*"):
            if path.is_file():
                self.store[(bucket, str(path.relative_to(root)))] = path.read_bytes()


@pytest.fixture
def fake_s3(monkeypatch):
    """A FakeS3 that every client the port makes is."""
    fake = FakeS3()
    monkeypatch.setattr(s3_utils, "make_client", lambda *a, **kw: fake)
    monkeypatch.setattr(s3_sync, "make_client", lambda *a, **kw: fake)
    monkeypatch.setattr(s3_utils, "_CLIENTS", {})
    return fake


def test_s3_paths():
    assert s3_utils.is_s3_path("s3://b/k") and not s3_utils.is_s3_path("/b/k")
    assert s3_utils.parse_s3_path("s3://bucket/a/b.tar") == ("bucket", "a/b.tar")
    with pytest.raises(ValueError):
        s3_utils.parse_s3_path("s3://bucket")


def test_no_boto3_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setattr(s3_utils, "_CLIENTS", {})
    with pytest.raises(RuntimeError, match="boto3"):
        s3_utils.make_client()
    with pytest.raises(RuntimeError, match="boto3"):
        s3_sync.latest_s3_checkpoint("s3://b/run")
    with pytest.raises(RuntimeError, match="boto3"):
        list(tar_reader.iter_tar_samples("s3://b/shard-000.tar"))
    args = run_training.get_args(["--synthetic_data", "--scaled_modalities", "--device", "cpu",
                                  "--model", NAME, "--output_dir", str(tmp_path),
                                  "--s3_save_dir", "s3://b/run"])
    with pytest.raises(RuntimeError, match="boto3"):
        run_training.main(args)


def test_s3_shard_reads_as_the_local_tar(tmp_path, fake_s3):
    pattern, _ = write_tree(tmp_path / "local", "set", 2, 3, seed=0)
    fake_s3.put_tree(tmp_path / "local", "bucket")
    local = per_mod_paths(tmp_path / "local", "set", 2)
    remote = per_mod_paths("s3://bucket", "set", 2)
    want = list(tar_reader.multi_tarfile_samples(local))
    for client in (fake_s3, None):  # injected, or this process's client
        got = list(tar_reader.multi_tarfile_samples(remote, s3_client=client))
        assert [g["__key__"] for g in got] == [w["__key__"] for w in want]
        for g, w in zip(got, want):
            for m in local:
                np.testing.assert_array_equal(g[m], w[m])
    assert s3_utils.download_to_memory(remote["tok_rgb"][0]).read() == \
        pathlib.Path(local["tok_rgb"][0]).read_bytes()


def _model():
    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info())
    return model.init_random_(torch.Generator().manual_seed(0))


def test_s3_checkpoint_round_trip(tmp_path, fake_s3):
    """Upload, the newest by listing (through two-key pages), wipe local,
    the resume assist downloads it; a local checkpoint wins."""
    out, s3_dir = tmp_path / "run", "s3://ckpts/exp1"
    model = _model()
    paths = [save_checkpoint(out, tag, model, step=tag) for tag in (3, 5, 10)]
    assert s3_sync.latest_s3_checkpoint(s3_dir, client=fake_s3) is None
    for p in paths:
        assert s3_sync.upload_checkpoint(p, s3_dir, client=fake_s3).startswith(s3_dir)
    save_checkpoint(out, "final", model, step=11)
    s3_sync.upload_checkpoint(str(out / "checkpoint-final.pth"), s3_dir, client=fake_s3)
    assert len(fake_s3.store) == 4
    assert s3_sync.latest_s3_checkpoint(s3_dir, client=fake_s3) == \
        "s3://ckpts/exp1/checkpoint-10.pth"
    shutil.rmtree(out)
    out.mkdir()
    fetched = s3_sync.maybe_download_for_resume(str(out), s3_dir, client=fake_s3)
    assert fetched == str(out / "checkpoint-10.pth") == latest_checkpoint(str(out))
    got = load_pth(fetched)
    assert got["step"] == 10
    for k, v in model.state_dict().items():
        assert torch.equal(got["model"][k], v), k
    assert s3_sync.maybe_download_for_resume(str(out), s3_dir, client=fake_s3) is None
    with pytest.raises(FileNotFoundError):
        s3_sync.download_checkpoint("s3://ckpts/exp1/checkpoint-7.pth", str(tmp_path / "x.pth"),
                                    client=fake_s3)


def test_upload_after_an_async_save_waits_for_its_write(tmp_path, fake_s3):
    model = _model()
    path = save_checkpoint(tmp_path / "run", "final", model, step=2, blocking=False)
    s3_sync.upload_after_save(path, "s3://ckpts/exp2", blocking_save=False, client=fake_s3)
    s3_sync.wait_for_uploads()
    assert fake_s3.store[("ckpts", "exp2/checkpoint-final.pth")] == pathlib.Path(path).read_bytes()


def test_trainer_syncs_checkpoints_with_s3_and_resumes_from_the_bucket(tmp_path, fake_s3):
    """--s3_save_dir: every save uploaded (the periodic one after its async
    write); a fresh output directory resumes from the bucket's newest."""
    out = tmp_path / "run"

    def run(epochs):
        args = run_training.get_args([
            "--synthetic_data", "--scaled_modalities", "--model", NAME, "--num_input_tokens",
            "32", "--num_target_tokens", "32", "--batch_size", "2", "--epochs", str(epochs),
            "--epoch_size", "4", "--eval_freq", "0", "--lr_schedule", "constant", "--device",
            "cpu", "--output_dir", str(out), "--s3_save_dir", "s3://ckpts/run",
            "--s3_endpoint", "http://localhost:9000"])
        return run_training.main(args)

    run(2)
    assert sorted(k for _, k in fake_s3.store) == ["run/checkpoint-0.pth",
                                                   "run/checkpoint-final.pth"]
    assert fake_s3.store[("ckpts", "run/checkpoint-final.pth")] == \
        (out / "checkpoint-final.pth").read_bytes()
    shutil.rmtree(out)
    res = run(3)
    # the numbered checkpoint wins over final, as in the JAX trainer: the
    # run resumes from checkpoint-0.pth (step 2) and trains epochs 1 and 2
    assert load_pth(str(out / "checkpoint-0.pth"))["step"] == 2
    assert len(res["metrics"]) == 4
    assert load_pth(str(out / "checkpoint-final.pth"))["step"] == 6
    assert sorted(k for _, k in fake_s3.store) == ["run/checkpoint-0.pth", "run/checkpoint-1.pth",
                                                   "run/checkpoint-final.pth"]


def test_trainer_reads_s3_shards(tmp_path, fake_s3):
    pattern, _ = write_tree(tmp_path / "local", "set", 2, 4, seed=1, vocab={"tok_rgb": 1000,
                                                                             "tok_cam": 256})
    fake_s3.put_tree(tmp_path / "local", "bucket")
    remote = pattern.replace(str(tmp_path / "local"), "s3://bucket")
    args, _ = shard_args(tmp_path, remote, "--model", NAME, "--device", "cpu",
                         "--epochs", "1", "--epoch_size", "4", "--eval_freq", "0",
                         "--output_dir", str(tmp_path / "out"), "--s3_data_endpoint",
                         "http://localhost:9000", jax_args=False)
    loader, domains = run_training.setup_data(args)
    it = iter(loader)
    try:
        batch = next(it)
    finally:
        it.close()
    assert domains == ["tok_cam", "tok_rgb"] and batch["tok_rgb"]["tensor"].shape == (2, 5, 32, 32)
    keys = {k for (_, k) in fake_s3.store}
    assert keys == {f"{d}/set/shard-00{i}.tar" for d in ("rgb", "cam") for i in (0, 1)}


# ------------------------------------------------------------ Hugging Face
datasets = pytest.importorskip("datasets")


def _hf_rows(rng, n):
    return {"tok_rgb": [rng.integers(0, 1000, (5, 32, 32)).tolist() for _ in range(n)],
            "tok_cam": [rng.integers(0, 256, 30).tolist() for _ in range(n)],
            "text": [f"clip {i}" for i in range(n)]}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    rng = np.random.default_rng(0)
    datasets.Dataset.from_dict(_hf_rows(rng, 12)).save_to_disk(str(root / "plain"))
    datasets.DatasetDict({"train": datasets.Dataset.from_dict(_hf_rows(rng, 6)),
                          "val": datasets.Dataset.from_dict(_hf_rows(rng, 4))}
                         ).save_to_disk(str(root / "dict"))
    return root


@pytest.mark.parametrize("where, split, buffer, seed", [
    ("plain", "train", 0, 0), ("plain", "train", 5, 3), ("dict", "val", 0, 0),
    ("dict", "train", 4, 7)])
def test_hf_samples_are_jax_samples_in_jax_order(hf_dirs, where, split, buffer, seed):
    from egom2p_torch.data.hf_datasets import huggingface_samples
    from egom2p_tpu.data.hf_datasets import huggingface_samples as jax_samples
    path = str(hf_dirs / where)
    got = list(huggingface_samples(path, split=split, shuffle_buffer=buffer, seed=seed))
    want = list(jax_samples(path, split=split, shuffle_buffer=buffer, seed=seed))
    assert got == want and len(got) == {"plain": 12, "dict": 6 if split == "train" else 4}[where]
    assert "caption" in got[0] and "text" not in got[0]
    if buffer:  # shuffled, from the seed
        assert [g["caption"] for g in got] != sorted(g["caption"] for g in got)


def test_hf_dataset_missing_or_not_on_disk_raises(hf_dirs, monkeypatch, tmp_path):
    from egom2p_torch.data.hf_datasets import huggingface_samples
    with pytest.raises(ValueError, match="split 'test' not found"):
        next(huggingface_samples(str(hf_dirs / "dict"), split="test"))
    with pytest.raises(FileNotFoundError, match="save_to_disk"):
        next(huggingface_samples(str(tmp_path)))
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets"):
        next(huggingface_samples(str(hf_dirs / "plain")))


def test_hf_dataset_trains_through_setup_data(hf_dirs, tmp_path):
    """A data config's dataset of type huggingface: the trainer's loader
    masks its samples as the shards' and two steps train on them."""
    args, _ = shard_args(tmp_path, str(hf_dirs / "plain"), "--model", NAME, "--device", "cpu",
                         "--epochs", "1", "--epoch_size", "4", "--eval_freq", "0",
                         "--num_input_tokens", "32", "--num_target_tokens", "32",
                         "--output_dir", str(tmp_path / "out"), jax_args=False)
    cfg = json.loads((tmp_path / "data.json").read_text())
    cfg["train"]["datasets"]["set"].update(type="huggingface", shuffle_buffer_load=4)
    (tmp_path / "data.json").write_text(json.dumps(cfg))
    loader, domains = run_training.setup_data(args)
    it = iter(loader)
    try:
        batch = next(it)
    finally:
        it.close()
    assert domains == ["tok_cam", "tok_rgb"]
    assert batch["tok_rgb"]["tensor"].shape == (2, 5, 32, 32)
    assert set(batch["tok_cam"]) == {"tensor", "input_mask", "target_mask",
                                     "decoder_attention_mask"}
    res = run_training.main(args)
    assert len(res["metrics"]) == 2 and all(np.isfinite(m["loss"]) for m in res["metrics"])
    shutil.rmtree(tmp_path / "out")
