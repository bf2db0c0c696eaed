"""Token shards on the port against the JAX package: the tar reader, the
config loaders, the masking branches the shard path reaches, and the
mixture loader with its forked workers (egom2p_torch/data/{tar_reader,
loader,masking}.py, egom2p_torch/core/config.py).

The tests write aligned tars of tok_rgb (5 x 32 x 32 int32 npz) and
tok_cam (30,) tokens in the repo's shard layout, a few samples a shard,
from a seed; the same files go through both packages.
"""
import copy
import io
import json
import pathlib
import random
import sys
import tarfile

import jax
import numpy as np
import pytest

import egom2p_torch.data.tar_reader as port_tar
import egom2p_tpu.data.tar_reader as jax_tar
import run_training_egom2p as jax_trainer
from egom2p_torch.cli import run_training
from egom2p_torch.core import config as port_config
from egom2p_torch.data.loader import DatasetStream, MixtureLoader, make_empty_mod_entry
from egom2p_torch.data.masking import UnifiedMasking
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_tpu.core import config as jax_config
from egom2p_tpu.core.mesh import make_mesh
from egom2p_tpu.data.mixture import DatasetStream as JaxDatasetStream
from egom2p_tpu.data.mixture import MixtureLoader as JaxMixtureLoader
from egom2p_tpu.data.mixture import make_empty_mod_entry as jax_empty_entry
from egom2p_tpu.masking.unified import UnifiedMasking as JaxUnifiedMasking

REPO = pathlib.Path(__file__).resolve().parent.parent
SHAPES = {"tok_rgb": (5, 32, 32), "tok_cam": (30,)}
DIRS = {"tok_rgb": "rgb", "tok_cam": "cam"}
VOCAB = {"tok_rgb": 64000, "tok_cam": 256}


def _npz(arr) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, arr)
    return buf.getvalue()


def _add(tar, name, data: bytes):
    info = tarfile.TarInfo(name=name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def write_tree(root, name, n_shards, per_shard, seed, mods=("tok_rgb", "tok_cam"),
               vocab=VOCAB):
    """Aligned shards root/<rgb|cam>/<name>/shard-{000..}.tar of seeded
    tokens below `vocab`, keys <name>_<shard>_<sample>; returns (the
    data_path pattern, {key: {mod: tokens}})."""
    rng = np.random.default_rng(seed)
    samples = {}
    for s in range(n_shards):
        keys = [f"{name}_{s:03d}_{j:03d}" for j in range(per_shard)]
        for k in keys:
            samples[k] = {m: rng.integers(0, vocab[m], SHAPES[m]).astype(np.int32)
                          for m in mods}
        for m in mods:
            d = pathlib.Path(root) / DIRS[m] / name
            d.mkdir(parents=True, exist_ok=True)
            with tarfile.open(d / f"shard-{s:03d}.tar", "w") as tar:
                for k in keys:
                    _add(tar, f"{k}.npz", _npz(samples[k][m]))
    pattern = (f"{root}/[{','.join(DIRS[m] for m in mods)}]/{name}/"
               f"shard-{{000..{n_shards - 1:03d}}}.tar")
    return pattern, samples


def per_mod_paths(root, name, n_shards, mods=("tok_rgb", "tok_cam")):
    return {m: [f"{root}/{DIRS[m]}/{name}/shard-{s:03d}.tar" for s in range(n_shards)]
            for m in mods}


def assert_samples_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert x["__key__"] == y["__key__"]
        for k in x:
            if k != "__key__":
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for m in a:
        assert a[m].keys() == b[m].keys()
        for k in a[m]:
            np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
            assert a[m][k].dtype == b[m][k].dtype, (m, k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    pattern, samples = write_tree(root, "train", 3, 4, seed=0)
    return root, pattern, samples


# ------------------------------------------------------------------ reader
def test_braceexpand_and_shard_split_match_jax():
    for pattern in ("shard-{000..002}.tar", "[rgb,depth]/s-{00..01}.tar", "plain.tar",
                    "/d/[rgb,depth,cam,gaze]/x/shard-{000000..000195}.tar"):
        assert port_tar.braceexpand(pattern) == jax_tar.braceexpand(pattern)
    items = list(range(11))
    for rank, world in ((0, 1), (0, 2), (1, 2), (2, 3)):
        assert port_tar.shard_split(items, rank, world) == jax_tar.shard_split(items, rank,
                                                                               world)


def test_tar_samples_shuffled_and_repeated_match_jax(tree):
    """One seed: the same sample sequences from multi_tarfile_samples,
    shuffled and repeated in both packages."""
    root, _, samples = tree
    paths = per_mod_paths(root, "train", 3)
    port = list(port_tar.multi_tarfile_samples(paths))
    ref = list(jax_tar.multi_tarfile_samples(paths))
    assert_samples_equal(port, ref)
    assert [s["__key__"] for s in port] == list(samples)
    np.testing.assert_array_equal(port[5]["tok_rgb"], samples[port[5]["__key__"]]["tok_rgb"])
    assert port[0]["tok_rgb"].shape == (5, 32, 32) and port[0]["tok_cam"].shape == (30,)
    for buf in (0, 5, 100):
        assert_samples_equal(
            list(port_tar.shuffled(port_tar.multi_tarfile_samples(paths), buf,
                                   random.Random(3))),
            list(jax_tar.shuffled(jax_tar.multi_tarfile_samples(paths), buf,
                                  random.Random(3))))
    rep = list(port_tar.repeated(lambda: port_tar.multi_tarfile_samples(paths), 2))
    assert_samples_equal(rep, list(jax_tar.repeated(
        lambda: jax_tar.multi_tarfile_samples(paths), 2)))
    assert [s["__key__"] for s in rep[:4]] == [port[0]["__key__"]] * 2 + [port[1]["__key__"]] * 2


def test_bad_shards_are_skipped_as_in_jax(tmp_path, capsys):
    """A shard whose keys diverge across modalities, one with a member
    short of samples and one with a truncated npz (zipfile.BadZipFile) are
    skipped with a warning, the good shards read; handler='raise' raises."""
    _, samples = write_tree(tmp_path, "d", 4, 3, seed=1)
    cam = tmp_path / "cam" / "d"
    with tarfile.open(cam / "shard-001.tar", "w") as tar:  # misaligned keys
        for j, k in enumerate(list(samples)[3:6]):
            _add(tar, f"{k if j != 1 else 'other'}.npz", _npz(samples[k]["tok_cam"]))
    with tarfile.open(cam / "shard-002.tar", "w") as tar:  # one sample short
        for k in list(samples)[6:8]:
            _add(tar, f"{k}.npz", _npz(samples[k]["tok_cam"]))
    with tarfile.open(cam / "shard-003.tar", "w") as tar:  # truncated npz
        for k in list(samples)[9:12]:
            _add(tar, f"{k}.npz", _npz(samples[k]["tok_cam"])[:40])
    paths = per_mod_paths(tmp_path, "d", 4)
    port = list(port_tar.multi_tarfile_samples(paths, handler="warn"))
    port_out = capsys.readouterr().out
    ref = list(jax_tar.multi_tarfile_samples(paths, handler="warn"))
    assert capsys.readouterr().out == port_out
    assert_samples_equal(port, ref)
    assert {s["__key__"][:5] for s in port} >= {"d_000"}
    assert [s["__key__"] for s in port[:3]] == list(samples)[:3]
    for shard in (1, 2, 3):
        assert f"skipping bad shard {shard}" in port_out
    for reader in (port_tar, jax_tar):
        with pytest.raises(ValueError):
            list(reader.multi_tarfile_samples(paths, handler="raise"))


def test_s3_shards_raise(monkeypatch):
    """An s3:// shard with no client given and no boto3 raises, naming
    boto3 (tests/test_torch_s3_hf.py reads one through a client)."""
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(RuntimeError, match="boto3"):
        list(port_tar.multi_tarfile_samples({"tok_rgb": ["s3://bucket/shard-000.tar"]}))


# ------------------------------------------------------------------ configs
def _alphas_fields(mod_info):
    return {m: (v["input_alphas"], v["target_alphas"], v.get("keep"))
            for m, v in mod_info.items()}


@pytest.mark.parametrize("variant", ["yaml", "json", "none", "none_split"])
def test_setup_sampling_mod_info_matches_jax(tmp_path, monkeypatch, variant):
    """cfgs/alphas/mod4_uniform.yaml, a JSON copy of it, and a config with no
    alphas_config (one alpha for all, or one per domain in sorted order)."""
    yaml_path = REPO / "cfgs" / "alphas" / "mod4_uniform.yaml"
    dcfg = {"in_domains": "tok_rgb-tok_depth-tok_gaze-tok_cam",
            "out_domains": "tok_rgb-tok_depth-tok_gaze-tok_cam"}
    if variant == "yaml":
        dcfg["alphas_config"] = str(yaml_path.relative_to(REPO))
        monkeypatch.chdir(REPO)  # relative to the working directory
    elif variant == "json":
        import yaml
        (tmp_path / "alphas").mkdir()
        (tmp_path / "alphas" / "a.json").write_text(
            json.dumps(yaml.safe_load(yaml_path.read_text())))
        dcfg["alphas_config"] = "alphas/a.json"
        monkeypatch.chdir(tmp_path)
    elif variant == "none":
        dcfg.update(input_alphas=0.5, target_alphas="2.0")
    else:
        dcfg.update(input_alphas="0.1-0.2-0.3-0.4", target_alphas=None)
    port_info, port_w = port_config.setup_sampling_mod_info(dcfg, MODALITY_INFO)
    ref_info, ref_w = jax_config.setup_sampling_mod_info(dcfg, jax_config_info())
    assert port_w == ref_w
    assert list(port_info) == list(ref_info) == sorted(dcfg["in_domains"].split("-"))
    assert _alphas_fields(port_info) == _alphas_fields(ref_info)
    if variant in ("yaml", "json"):
        assert port_w == [1.0] * 4 and port_info["tok_rgb"]["input_alphas"] == [0.01, 0.1, 1.0,
                                                                                10.0]
    else:
        assert port_w is None


def jax_config_info():
    from egom2p_tpu.data.modality_info import MODALITY_INFO as JAX_INFO
    return JAX_INFO


def test_config_files_load_as_json_without_pyyaml(tmp_path, monkeypatch):
    """A JSON config loads with no PyYAML; a YAML one then raises naming
    PyYAML; with PyYAML the repo's YAML configs load as the JAX package
    loads them."""
    for path in ("cfgs/egom2p/data_mod4.yaml", "cfgs/egom2p/main_mod4.yaml",
                 "cfgs/alphas/mod4_uniform.yaml"):
        assert port_config.load_config_file(str(REPO / path)) == \
            jax_config.load_data_config(str(REPO / path))
    data = jax_config.load_data_config(str(REPO / "cfgs/egom2p/data_mod4.yaml"))
    (tmp_path / "d.json").write_text(json.dumps(data))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    assert port_config.load_data_config(str(tmp_path / "d.json")) == data
    with pytest.raises(ImportError, match="PyYAML"):
        port_config.load_data_config(str(REPO / "cfgs/egom2p/data_mod4.yaml"))
    args = run_training.get_args(["--config", str(tmp_path / "d.json")])  # unknown keys only
    assert args.config == str(tmp_path / "d.json")


def test_str2bool_and_run_name_match_jax():
    for v in ("true", "False", "1", "no", True):
        assert port_config.str2bool(v) == jax_config.str2bool(v)
    for cfg, out in (("cfgs/egom2p/main_mod4.yaml", "output/auto"), (None, "x/auto"),
                     (None, "plain")):
        a = run_training.get_args(["--output_dir", out])
        a.config = cfg
        b = copy.deepcopy(a)
        port_config.setup_run_name(a)
        jax_config.setup_run_name(b)
        assert (a.run_name, a.output_dir) == (b.run_name, b.output_dir)


# ------------------------------------------------------------------ masking
def _info(mods=("tok_rgb", "tok_cam"), alphas=(0.01, 0.1, 1.0, 10.0)):
    info = {m: copy.deepcopy(MODALITY_INFO[m]) for m in mods}
    for m in info:
        info[m]["input_alphas"] = list(alphas)
        info[m]["target_alphas"] = list(alphas)
    return info


@pytest.mark.parametrize("weights,inputs,targets", [
    (None, 128, 128),        # no alphas_config: a uniform mixture draw
    ([1.0, 2.0, 1.0, 0.5], 64, None),   # no target budget: every other token
    (None, (128, 128), (128, 128)),     # fixed eval's pinned budgets
    ([1.0] * 4, (40, 200), (10, 300)),
])
def test_masking_branches_match_jax(tree, weights, inputs, targets):
    _, _, samples = tree
    info = _info()
    port = UnifiedMasking(info, inputs, targets, sampling_weights=weights, seed=4)
    ref = JaxUnifiedMasking(info, None, inputs, targets, sampling_weights=weights, seed=4)
    for key in list(samples)[:6]:
        a, b = port(samples[key]), ref(samples[key])
        for m in info:
            for k in b[m]:
                np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
        if targets is None:
            for m in info:
                assert np.array_equal(a[m]["target_mask"], ~a[m]["input_mask"])


# ------------------------------------------------------------------ loader
def test_placeholders_match_jax():
    """Token grids, a caption's (max_tokens + 1) * 2 packed slots, T5
    embedding rows and raw pixels: JAX's shapes, dtypes and values."""
    jax_info = jax_config_info()
    for m in ("tok_rgb", "tok_cam", "tok_gaze", "caption", "t5_caption", "rgb@224"):
        a, b = make_empty_mod_entry(MODALITY_INFO[m]), jax_empty_entry(jax_info[m])
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert make_empty_mod_entry(MODALITY_INFO["caption"])["tensor"].shape == (514,)


def test_mixture_loader_matches_jax(tree):
    """Two weighted datasets, the second without tok_cam (placeholders) and
    with its tokens stored as int16: batches bitwise equal to JAX's."""
    root, _, _ = tree
    paths = per_mod_paths(root, "train", 3)
    rng = np.random.default_rng(9)
    narrow = [{"tok_rgb": rng.integers(0, 30000, SHAPES["tok_rgb"]).astype(np.int16)}
              for _ in range(5)]
    info, info_rgb = _info(), _info(("tok_rgb",))
    info_all = {m: MODALITY_INFO[m] for m in sorted(info)}
    port = iter(MixtureLoader(
        [DatasetStream(lambda: port_tar.multi_tarfile_samples(paths),
                       UnifiedMasking(info, 100, 100, None, seed=1), name="shards"),
         DatasetStream(lambda: iter(narrow), UnifiedMasking(info_rgb, 100, 100, None, seed=2),
                       name="narrow")],
        info_all, 3, seed=5, weights=[2.0, 1.0]))
    ref = iter(JaxMixtureLoader(
        [JaxDatasetStream("shards", lambda: jax_tar.multi_tarfile_samples(paths),
                          JaxUnifiedMasking(info, None, 100, 100, seed=1)),
         JaxDatasetStream("narrow", lambda: iter(narrow),
                          JaxUnifiedMasking(info_rgb, None, 100, 100, seed=2))],
        [2.0, 1.0], info_all, 3, seed=5))
    seen_placeholder = False
    for _ in range(6):
        a, b = next(port), next(ref)
        assert_batches_equal(a, b)
        assert a["tok_rgb"]["tensor"].dtype == np.int32
        seen_placeholder |= bool(a["tok_cam"]["input_mask"].all(axis=1).any())
    port.close()
    ref.close()
    assert seen_placeholder


def shard_args(tmp_path, pattern, *extra, val_pattern=None, jax_args=True):
    """Both trainers' args (the port's only without `jax_args`) over a JSON
    data config of the shards at `pattern` (tok_rgb and tok_cam,
    cfgs/alphas/mod4_uniform.yaml's alphas as JSON), with a `val` section
    over `val_pattern` where given."""
    import yaml
    alphas = yaml.safe_load((REPO / "cfgs" / "alphas" / "mod4_uniform.yaml").read_text())
    (tmp_path / "alphas.json").write_text(json.dumps(alphas))
    train = {"type": "multimodal", "in_domains": "tok_rgb-tok_cam",
             "out_domains": "tok_rgb-tok_cam", "input_alphas": None, "target_alphas": None,
             "alphas_config": str(tmp_path / "alphas.json"), "data_path": pattern,
             "wds_n_repeats": 2, "wds_shuffle_buffer_tar": 5}
    cfg = {"train": {"datasets": {"set": train}, "weights": [1.0]}}
    if val_pattern is not None:
        cfg["val"] = {"datasets": {"set": {"data_path": val_pattern}}}
    (tmp_path / "data.json").write_text(json.dumps(cfg))
    argv = ["--data_config", str(tmp_path / "data.json"), "--batch_size", "2",
            "--num_input_tokens", "64", "--num_target_tokens", "64", "--seed", "3", *extra]
    return run_training.get_args(argv), jax_trainer.get_args(argv) if jax_args else None


class _Enough(BaseException):
    """Stops a worker loop run in this process after a few batches."""


class _ListQueue:
    def __init__(self, n):
        self.items, self.n = [], n

    def put(self, item):
        if isinstance(item, Exception):
            raise item
        self.items.append(item)
        if len(self.items) == self.n:
            raise _Enough


def worker_batches(loader, worker_id, n):
    """The first `n` batches of worker `worker_id`'s loop body, run here."""
    q = _ListQueue(n)
    with pytest.raises(_Enough):
        loader._worker_loop(q, worker_id)
    return q.items


def test_worker_sequences_match_jax(tree, tmp_path):
    """Each worker's batch sequence (its seeds, its share of the shards, the
    crc32 name salt) equals the JAX worker's: the per-worker loop body of
    both packages' loaders, from setup_data of both trainers, run without
    a fork.  Worker 0 reads shards 0 and 2, worker 1 shard 1."""
    _, pattern, samples = tree
    port_args, jax_args = shard_args(tmp_path, pattern, "--num_workers", "2")
    mesh = make_mesh(devices=jax.devices()[:1])
    key_of = {v["tok_cam"].tobytes(): k for k, v in samples.items()}
    for w, shards in ((0, {"000", "002"}), (1, {"001"})):
        port_loader, port_domains = run_training.setup_data(port_args)
        jax_loader, jax_domains = jax_trainer.setup_data(jax_args, mesh)
        assert port_domains == jax_domains == ["tok_cam", "tok_rgb"]
        assert port_loader.num_workers == jax_loader.num_workers == 2
        a, b = worker_batches(port_loader, w, 5), worker_batches(jax_loader, w, 5)
        for x, y in zip(a, b):
            assert_batches_equal(x, y)
        read = {key_of[row.tobytes()].split("_")[1] for x in a for row in x["tok_cam"]["tensor"]}
        assert read <= shards and read


def test_forked_workers_give_the_worker_sequences_and_stop_on_close(tree, tmp_path):
    """A forked run with num_workers=2: each batch is one of the two
    workers' sequences' batches; closing the iterator ends every worker."""
    _, pattern, _ = tree
    port_args, _ = shard_args(tmp_path, pattern, "--num_workers", "2")
    loader, _ = run_training.setup_data(port_args)
    expected = [worker_batches(run_training.setup_data(port_args)[0], w, 8) for w in (0, 1)]
    it = iter(loader)
    assert len(it.workers) == 2 and all(p.is_alive() for p in it.workers)
    got = [next(it) for _ in range(5)]
    it.close()
    assert all(not p.is_alive() and p.exitcode is not None for p in it.workers)
    positions = {0: 0, 1: 0}
    for batch in got:
        for w in (0, 1):
            seq = expected[w]
            if positions[w] < len(seq) and all(
                    np.array_equal(batch[m][k], seq[positions[w]][m][k])
                    for m in batch for k in batch[m]):
                positions[w] += 1  # each worker's batches arrive in its order
                break
        else:
            raise AssertionError("a forked batch is in neither worker's sequence")
    with pytest.raises(StopIteration):
        next(it)
