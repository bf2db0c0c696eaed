"""Rules of the PyTorch port that hold on any machine: what its sources may
name, what its kernel wrappers refuse before a launch, and the bounds that
chip_smoke.py prints beside each kernel's time.  No CUDA device is needed.
"""
import itertools
import json
import pathlib
import re
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import egom2p_torch.ops.flash_ce as fce  # noqa: E402
from egom2p_torch.tools import sass_diff  # noqa: E402
from egom2p_torch.ops.flash64 import _kernel_operand  # noqa: E402

PORT_FILES = sorted([p for p in (REPO / "egom2p_torch").rglob("*")
                     if p.suffix in (".py", ".cu", ".cuh") and "build" not in p.parts]
                    # the data-parallel tests' rank processes run the port alone
                    + [REPO / "tests" / "torch_dist_ranks.py"])


@pytest.mark.parametrize("pattern,what", [
    (r"scaled_dot_product_attention", "PyTorch's fused attention"),
    (r"^\s*(import|from)\s+jax\b", "an import of JAX"),
    (r"^\s*(import|from)\s+flax\b", "an import of flax"),
    (r"^\s*(import|from)\s+egom2p_tpu\b", "an import of the JAX package"),
    (r"torch\.compile\(", "torch.compile"),
    (r"^\s*(import|from)\s+matplotlib\b", "an import of matplotlib"),
    (r"^\s*(import|from)\s+(run_training_vqvae|run_training_egom2p|tokenize_images|"
     r"tokenize_videos|eval_model_\w+|prepare_aligned_shards|vis_cam|vis_gaze|cam_viz_tool|"
     r"tok_cam_example|tok_gaze_example|bench|bench_train|__graft_entry__)\b",
     "an import of a root script"),
])
def test_port_sources_do_not_name(pattern, what):
    """No file of the port calls a library's attention, compiles its plain
    versions, or imports JAX, the JAX package, matplotlib or a root script
    (docstrings may name the JAX files a module mirrors)."""
    assert len(PORT_FILES) > 40
    rx = re.compile(pattern, re.MULTILINE)
    found = [str(p.relative_to(REPO)) for p in PORT_FILES if rx.search(p.read_text())]
    assert not found, f"{what} in {found}"


@pytest.mark.parametrize("path", ["egom2p_torch/utils/__init__.py",
                                  "egom2p_torch/utils/text_tokenizer.py",
                                  "egom2p_torch/data/span.py"])
def test_text_modules_are_the_port_own_copies(path):
    """The tokenizer and the span functions are the port's own copies of
    the JAX package's pure-Python modules: covered by the import rule above
    and importing neither JAX nor the JAX package."""
    assert REPO / path in PORT_FILES
    text = (REPO / path).read_text()
    for pattern in (r"^\s*(import|from)\s+(jax|flax|egom2p_tpu)\b", r"egom2p_tpu\.\w+ import"):
        assert not re.search(pattern, text, re.MULTILINE), (path, pattern)


def test_tokenizers_is_imported_only_to_train_a_tokenizer():
    """The card's machine has no `tokenizers` package: no source of the port
    (nor chip_smoke.py) imports it at module level, and the one import is
    inside train_unified_wordpiece_tokenizer's body."""
    import ast
    found = []
    for p in PORT_FILES + [REPO / "chip_smoke.py"]:
        if p.suffix != ".py":
            continue
        tree = ast.parse(p.read_text())
        scopes = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in ast.walk(node):
                    scopes.setdefault(id(child), node.name)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n == "tokenizers" or n.startswith("tokenizers.") for n in names):
                found.append((str(p.relative_to(REPO)), scopes.get(id(node))))
    assert found and set(found) == {("egom2p_torch/utils/text_tokenizer.py",
                                     "train_unified_wordpiece_tokenizer")}, found


def test_forward_kernel_sources_are_split_by_head_dim():
    """One wgmma forward template serves heads of 64 and 80 (the stock
    route's width-80 instances): it holds no mma.sync product, and no
    separate head_dim-80 source or entry point is left."""
    csrc = REPO / "egom2p_torch" / "csrc"
    fwd = (csrc / "flash64_fwd.cu").read_text()
    assert "wgmma_ss" in fwd and "wgmma_rs" in fwd and "tma_load_3d" in fwd
    assert "mma_16816" not in fwd and "cp_async16" not in fwd
    assert "template <int kHD, bool kSafemax, bool kSeg, bool kL2>" in fwd
    assert "launch_fwd<80, true, true, true>" in fwd and "smem_desc_sw32" in fwd
    assert not (csrc / "flash80_fwd.cu").exists() and "egom2p_flash80" not in fwd
    assert "wgmma_ss" in (csrc / "flash_ce_bwd.cu").read_text()


def test_backward_kernel_sources_are_split_by_head_dim():
    """The backward (dq, dk/dv, fused) is on wgmma and TMA and holds no
    mma.sync product, cp.async tile load or atomic add; the fused kernel's
    template takes heads of 64 and 80, and the launcher calls the same entry
    points at both widths (no branch on a file)."""
    csrc = REPO / "egom2p_torch" / "csrc"
    bwd = (csrc / "flash64_train.cu").read_text()
    for name in ("wgmma_ss", "wgmma_rs", "tma_load_3d", "tma_reduce_add_3d", "setmaxnreg_inc",
                 "template <int kHD, bool kClampMode, bool kSeg, bool kFused>",
                 "flash64_dkv_kernel<80, false, kSeg, true>", "smem_desc_sw32"):
        assert name in bwd, name
    assert "mma_16816" not in bwd and "cp_async16" not in bwd and "atomicAdd" not in bwd
    for entry in ("egom2p_flash64_train_dq", "egom2p_flash64_train_dkv",
                  "egom2p_flash64_train_dqkv"):
        assert f'extern "C" int {entry}(' in bwd
    assert not (csrc / "flash80_bwd.cu").exists()
    launcher = (REPO / "egom2p_torch" / "ops" / "flash64_train.py").read_text()
    assert "flash80" not in launcher and "if hd == 80 else" not in launcher


def test_ce_forward_kernel_is_wgmma_and_shares_the_live_row_scan():
    """The CE forward issues its products as wgmma on TMA-loaded tiles (no
    mma.sync and no cp.async left), and the forward and the backward find
    their live rows with one scan kernel from a shared header."""
    csrc = REPO / "egom2p_torch" / "csrc"
    fwd = (csrc / "flash_ce_fwd.cu").read_text()
    for name in ("wgmma_ss", "tma_load_2d", "mbar_wait", "flash_ce_combine_kernel",
                 "ce_live_scan_kernel<kRows, uint8_t>"):
        assert name in fwd, name
    assert "mma_16816" not in fwd and "cp_async16" not in fwd and "ldmatrix" not in fwd
    bwd = (csrc / "flash_ce_bwd.cu").read_text()
    assert "ce_live_scan_kernel<kWalk, float>" in bwd and "__global__" not in (
        bwd.split("ce_live_scan_kernel")[0].split("#include")[0])
    scan = (csrc / "ce_scan.cuh").read_text()
    assert "ce_live_scan_kernel(" in scan
    assert sum("ce_live_scan_kernel(" in (csrc / f).read_text()
               for f in ("flash_ce_fwd.cu", "flash_ce_bwd.cu", "ce_scan.cuh")) == 1


@pytest.mark.parametrize("R", [1, 127, 129, 512, 1000, 2048, 16384, 65536, 200000])
def test_ce_forward_split_plan(R):
    """The forward kernel's vocab slices: S >= 1, S slices of
    ceil(tiles / S) whole 256-column tiles cover V with none empty, each at
    least FWD_MIN_SLICE_STEPS k-steps deep where V allows, and S = 1 once
    the 128-row blocks alone fill the card FWD_WAVES times."""
    for D, V, n_sm in itertools.product((128, 768, 1024, 2048), (200, 700, 64000, 64007),
                                        (1, 8, 114, 132)):
        S = fce.fwd_splits(R, D, V, n_sm)
        tiles = -(-V // fce.FWD_COLS)
        per = -(-tiles // S)
        min_tiles = -(-fce.FWD_MIN_SLICE_STEPS // (D // 64))
        assert 1 <= S <= tiles
        assert per * S >= tiles and per * (S - 1) < tiles  # covered, the last slice not empty
        assert per >= min(min_tiles, tiles)  # deep enough where V allows
        blocks = -(-R // fce.FWD_ROWS)
        if blocks >= fce.FWD_WAVES * n_sm:
            assert S == 1
        # the shortest slices that fill the card: one tile less a slice would
        # give more pairs than it needs, or be too shallow
        assert (per in (min_tiles, tiles)
                or blocks * -(-tiles // (per - 1)) > fce.FWD_WAVES * n_sm)


def test_ce_forward_split_plan_refuses_what_the_kernel_refuses():
    for bad in ((0, 768, 64000, 132), (16, 768, 0, 132), (16, 768, 64000, 0)):
        with pytest.raises(ValueError):
            fce.fwd_splits(*bad)
    with pytest.raises(ValueError, match="multiple of 128"):
        fce.fwd_splits(16, 1020, 64000, 132)
    assert fce.fwd_splits(16384, 768, 64000, 132) == 9
    assert fce.fwd_splits(1000, 768, 64007, 132) == 126


def test_tensor_map_helpers_are_shared():
    """One helper builds the tensor maps of q, k, v and do for the forward
    and the backward kernels (TMA's layout rules hold for all four)."""
    csrc = REPO / "egom2p_torch" / "csrc"
    assert "inline int attention_operand_map(" in (csrc / "hopper.cuh").read_text()
    for name in ("flash64_fwd.cu", "flash64_train.cu"):
        assert "attention_operand_map(" in (csrc / name).read_text(), name


# The table of PERF.md: the card's bound for each kernel at its main path's
# shape, on 989 TFLOP/s dense bf16 and 3.35 TB/s
@pytest.mark.parametrize("got,want_ms", [
    (chip_smoke.attention_bound_ms(2, 8, 12, 8704, 8704, 64), 1.88),      # serving forward
    (chip_smoke.attention_bound_ms(2, 8, 12, 2048, 2048, 64), 0.104),     # training forward
    (chip_smoke.attention_bound_ms(3, 8, 12, 2048, 2048, 64, 3, 2), 0.156),   # dq
    (chip_smoke.attention_bound_ms(4, 8, 12, 2048, 2048, 64, 2, 4), 0.208),   # dk/dv
    (chip_smoke.attention_bound_ms(5, 8, 12, 2048, 2048, 64, 4, 4), 0.261),   # fused backward
    (chip_smoke.ce_fwd_bound_ms(16384, 768, 64000), 1.63),
    (chip_smoke.ce_bwd_bound_ms(8192, 16384, 768, 64000), 2.44),          # half the rows live
    (chip_smoke.ce_bwd_bound_ms(16384, 16384, 768, 64000), 4.89),
    (chip_smoke.attention_bound_ms(2, 8, 15, 2048, 2048, 68), 0.138),     # heads of 68, forward
    (chip_smoke.attention_bound_ms(5, 8, 15, 2048, 2048, 68, 4, 4), 0.346),
])
def test_bounds_at_the_table_shapes(got, want_ms):
    ms, by = got
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=5e-3)


def test_bound_is_the_larger_of_bytes_and_operations():
    # one product over one key: 4 tensors of bytes, almost no arithmetic
    ms, by = chip_smoke.attention_bound_ms(2, 8, 12, 8704, 1, 64)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 8 * 12 * 64 * (2 * 8704 + 2) / 3350e9 * 1e3, rel=1e-6)
    # the exp2 pass: one result per score, 16 per SM per clock on 132 SMs
    assert chip_smoke.exp2_bound_ms(8, 12, 8704, 8704, 1980.0) == pytest.approx(1.739, rel=1e-3)


@pytest.mark.parametrize("make,reason", [
    (lambda t: t[:, :, 1:129], "a base that is not 16-byte aligned"),
    (lambda t: t.transpose(1, 2)[:, :128, :], "no unit stride inside a row"),
    (lambda t: torch.zeros((2, 8, 132), dtype=torch.bfloat16)[:, :, :128],
     "a row stride of 132 elements"),
    (lambda t: torch.zeros(2100, dtype=torch.bfloat16).as_strided((2, 8, 128), (1028, 128, 1)),
     "a batch stride that is no multiple of 8 elements"),
])
def test_attention_operand_layouts_the_tile_loads_cannot_take_raise(make, reason):
    """The forward kernel loads q/k/v tiles by TMA: a 16-byte aligned base,
    row and batch strides of whole 16 bytes, unit stride inside a row."""
    t = torch.zeros((2, 8, 256), dtype=torch.bfloat16)
    view = t[:, :, 128:]  # a view of a fused projection is fine
    assert _kernel_operand("q", view).data_ptr() == view.data_ptr()
    with pytest.raises(ValueError):
        _kernel_operand("q", make(t))


# the backward kernel's column plan: the warpgroup widths of each column group
CE_PLANS = {128: ((128,),), 384: ((256, 128),), 640: ((256, 256, 128),),
            768: ((256, 256, 256),), 896: ((128,),) * 7, 1024: ((256, 256),) * 2,
            1280: ((256,),) * 5, 1536: ((256, 256),) * 3, 2048: ((256, 256),) * 4}


@pytest.mark.parametrize("D", list(range(128, 2049, 128)) + [0, 64, 100, 1000, 1020, 2046])
def test_ce_backward_column_plan(D):
    """The CE backward kernel's column plan takes every D the JAX kernel
    takes (a multiple of 128) up to 2048 and raises on any other: one group
    of all D columns up to 768 (256-column warpgroups, the last 128 wide for
    a remainder), above that equal groups of 512, 256 or 128 columns."""
    if D <= 0 or D % 128:
        with pytest.raises(ValueError, match="multiple of 128"):
            fce.bwd_column_plan(D)
        return
    plan = fce.bwd_column_plan(D)
    if D in CE_PLANS:
        assert plan == CE_PLANS[D]
    width = sum(plan[0])
    assert all(g == plan[0] for g in plan) and width * len(plan) == D
    assert (len(plan) == 1) == (D <= 768)
    assert width <= 768 if D <= 768 else width in (512, 256, 128)
    assert all(w == 256 for w in plan[0][:-1]) and plan[0][-1] in (128, 256)
    assert fce.fwd_plan(D) == "streamed"


def test_ce_route_and_launchers_agree_on_every_registry_dim(monkeypatch):
    """For every registry model's dim, the model's route sends a 64k head to
    flash CE exactly where the JAX package does (vocab >= 4096 and D % 128 ==
    0), and both kernel launchers take that D there and raise elsewhere."""
    from types import SimpleNamespace

    import egom2p_torch.models.egom2p as tm
    from egom2p_torch.models.embeddings import TokenGridDecoderEmbedding

    routed = []
    monkeypatch.setattr(tm, "flash_ce_total",
                        lambda y, *a, **k: routed.append(y.shape[-1]) or y.new_zeros(()))
    dims = sorted({cfg["dim"] for cfg in tm.MODEL_REGISTRY.values()})
    assert {768, 1020, 1024, 2046, 2048} <= set(dims)
    for D in dims:
        fake = SimpleNamespace(decoder_embeddings={"tok_rgb": TokenGridDecoderEmbedding(4096, (2,), D)})
        y = torch.zeros((1, 3, D))
        target = torch.zeros((1, 3), dtype=torch.long)
        weights = torch.ones((1, 3), dtype=torch.bool)
        routed.clear()
        with torch.no_grad():
            tm.EgoM2P._chunked_masked_ce(fake, y, "tok_rgb", target, weights)
        jax_takes = D % 128 == 0  # egom2p_tpu/models/egom2p.py:390-391
        assert (routed == [D]) == jax_takes, D
        if jax_takes:
            fce.fwd_plan(D)
            fce.bwd_column_plan(D)
        else:
            for plan in (fce.fwd_plan, fce.bwd_column_plan):
                with pytest.raises(ValueError):
                    plan(D)


def test_sass_diff_matches_instances_across_a_new_head_width_parameter():
    """tools/sass_diff.py pairs an instance of a template that gained a
    leading head-width argument with its old self, skips other widths, and
    compares instructions without addresses, encodings, constant-bank
    offsets or branch targets."""
    old = """
        Function : _ZN47_GLOBAL__N__f3c81b78_14_flash64_fwd_cu_5156087e18flash64_fwd_kernelILb1ELb0ELb1EEEv14CUtensorMapS1_S1_NS_7FwdArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                           /* 0x000fe20000000800 */
        /*0010*/                   BRA 0x120 ;             /* 0x0000000000007947 */
        Function : _ZN12_GLOBAL__N_118flash_ce_fwd_kernelILb0EEEvPK13__nv_bfloat16
        /*0000*/                   EXIT ;                  /* 0x000000000000794d */
    """
    new = old.replace("kernelILb1ELb0ELb1E", "kernelILi64ELb1ELb0ELb1E").replace(
        "c[0x0][0x28]", "c[0x0][0x390]").replace("BRA 0x120", "BRA 0x140")
    new += """
        Function : _ZN47_GLOBAL__N__f3c81b78_14_flash64_fwd_cu_5156087e18flash64_fwd_kernelILi80ELb1ELb0ELb1EEEv14CUtensorMap
        /*0000*/                   NOP ;                   /* 0x0000000000007918 */
    """
    a, b = sass_diff.parse(old), sass_diff.parse(new)
    assert list(a) == list(b) == [("flash64_fwd_kernel", ("1", "0", "1"))]
    assert a == b and a[("flash64_fwd_kernel", ("1", "0", "1"))] == ["LDC R1, c[P]", "BRA N"]
    assert sass_diff.parse(new.replace("LDC R1", "LDC R2")) != a


def test_eval_path_imports_no_jax():
    """The slices' modules (eval entry points, checkpoints, Cosmos decode,
    mp4 in and out; the cam / gaze VQ-VAE, VQ lookup, cam / gaze host
    modules and metrics; the shard reader, loader, configs and train and
    eval steps; the VQ-VAE trainer, its eval and the two shard tools; the
    process group helpers and the data-parallel tests' rank module; the
    gradient quantizers, the Cosmos image tokenizers, the latent
    distributions and tokenize_images; the data transforms, the folder,
    generation and video datasets, prep, LoRA and the hub; the visualisers,
    their renderer and the tokenizer examples) and chip_smoke.py load
    without JAX or the JAX package, and without Pillow, OpenCV or
    matplotlib (which the card's machine may lack)."""
    import subprocess
    code = ("import sys\n"
            "import chip_smoke\n"
            "import egom2p_torch.cli.eval_model_rgb2depth, egom2p_torch.cli.eval_model_depth2rgb\n"
            "import egom2p_torch.core.checkpoint, egom2p_torch.generate.decode\n"
            "import egom2p_torch.data.video_ingest, egom2p_torch.cli.run_training\n"
            "import egom2p_torch.cli.eval_model_rgb2cam, egom2p_torch.cli.eval_model_rgb2gaze\n"
            "import egom2p_torch.ops.vq, egom2p_torch.tokenizers.seq_vqvae\n"
            "import egom2p_torch.data.cam_gaze, egom2p_torch.core.metrics\n"
            "import egom2p_torch.data.tar_reader, egom2p_torch.data.loader\n"
            "import egom2p_torch.core.config, egom2p_torch.train.egom2p_train\n"
            "import egom2p_torch.cli.run_training_vqvae, egom2p_torch.cli.tokenize_videos\n"
            "import egom2p_torch.train.vqvae_train, egom2p_torch.train.vqvae_eval\n"
            "import egom2p_torch.core.distributed\n"
            "import egom2p_torch.ops.quantizers, egom2p_torch.cli.tokenize_images\n"
            "import egom2p_torch.tokenizers.cosmos.image_network\n"
            "import egom2p_torch.tokenizers.cosmos.image_api\n"
            "import egom2p_torch.tokenizers.cosmos.layers2d\n"
            "import egom2p_torch.tokenizers.cosmos.distributions\n"
            "import egom2p_torch.data.rand_augment, egom2p_torch.data.resample\n"
            "import egom2p_torch.data.modality_transforms, egom2p_torch.data.folder_dataset\n"
            "import egom2p_torch.data.generation_datasets, egom2p_torch.data.prep\n"
            "import egom2p_torch.data.video_dataset, egom2p_torch.models.lora\n"
            "import egom2p_torch.models.hub, egom2p_torch.core.image_metrics\n"
            "import egom2p_torch.vis_3d.vis_gaze, egom2p_torch.vis_3d.vis_cam\n"
            "import egom2p_torch.vis_3d.cam_viz_tool, egom2p_torch.vis_3d.render\n"
            "import egom2p_torch.examples.tok_cam_example\n"
            "import egom2p_torch.examples.tok_gaze_example\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_dist_ranks\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
            " 'egom2p_tpu', 'PIL', 'cv2', 'matplotlib')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_launch_scripts_call_the_port():
    """egom2p_torch/scripts/*.sh start the port's CLIs as modules
    (`python -m egom2p_torch...`, `torchrun ... -m egom2p_torch...`) and name
    no root script and none of the TPU launch legs."""
    scripts = sorted((REPO / "egom2p_torch" / "scripts").glob("*.sh"))
    assert [p.name for p in scripts] == ["cam_tok_train.sh", "gaze_train.sh",
                                         "launch_torchrun.sh", "tokenize_cam.sh",
                                         "tokenize_gaze.sh"]
    for p in scripts:
        code = "\n".join(line for line in p.read_text().splitlines()
                         if not line.lstrip().startswith("#"))
        calls = re.findall(r"-m (\S+)", code)
        assert calls and all(c.startswith("egom2p_torch.cli.") for c in calls), p.name
        assert not re.search(r"\w+\.py\b|gcloud|LIBTPU|jax", code), p.name


def test_video_ingest_builds_the_repo_source_only(monkeypatch, tmp_path):
    """The port's video library is built from native/video_ingest.cpp, and
    nothing else, into a directory git ignores, under a name of its own."""
    import subprocess

    from egom2p_torch.data import video_ingest as vi
    assert pathlib.Path(vi.SOURCE) == REPO / "native" / "video_ingest.cpp"
    assert pathlib.Path(vi.LIBRARY).parent == REPO / "native" / "build"
    assert "native/build/" in (REPO / ".gitignore").read_text().split()
    assert pathlib.Path(vi.LIBRARY).name != "libvideoingest.so"
    seen = []
    monkeypatch.setattr(vi, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(vi, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: seen.append(cmd) or
                        subprocess.CompletedProcess(cmd, 1, "", "stopped"))
    with pytest.raises(RuntimeError, match="build failed"):
        vi.build()
    (cmd,) = seen
    assert cmd[0] == "g++" and [a for a in cmd if a.endswith((".cpp", ".cc", ".c"))] == [vi.SOURCE]


def test_chip_smoke_config_copies_mirror_the_yaml_files():
    """chip_smoke.py's JSON copies of cfgs/egom2p/data_mod4.yaml,
    cfgs/alphas/mod4_uniform.yaml and cfgs/vqvae/{cam,gaze}.yaml (used on a
    machine without PyYAML) equal the files key for key, and its argument
    copy of main_mod4.yaml gives the trainer the settings --config gives it
    (the data config and output directory apart: the script names its
    own)."""
    yaml = pytest.importorskip("yaml")
    from egom2p_torch.cli import run_training
    cfgs = REPO / "cfgs"
    assert chip_smoke.DATA_MOD4 == yaml.safe_load((cfgs / "egom2p/data_mod4.yaml").read_text())
    assert chip_smoke.ALPHAS_MOD4 == yaml.safe_load(
        (cfgs / "alphas/mod4_uniform.yaml").read_text())
    assert sorted(chip_smoke.VQVAE_CONFIGS) == ["cam", "gaze"]
    for domain, cfg in chip_smoke.VQVAE_CONFIGS.items():
        assert cfg == yaml.safe_load((cfgs / f"vqvae/{domain}.yaml").read_text()), domain
    by_config = vars(run_training.get_args(["--config", str(cfgs / "egom2p/main_mod4.yaml")]))
    by_args = vars(run_training.get_args(chip_smoke.MAIN_MOD4_ARGS))
    own = ("config", "data_config", "output_dir")
    assert {k: v for k, v in by_config.items() if k not in own} == \
        {k: v for k, v in by_args.items() if k not in own}


@pytest.mark.parametrize("domain,channels", [("cam", 9), ("gaze", 2)])
def test_chip_smoke_vqvae_flops_count_the_forward_products(domain, channels):
    """seq_vqvae_train_flops is 3 x the forward's products that torch's
    FLOP counter sees, at a small width: the encoder, the codebook lookup
    and the decoder."""
    from torch.utils.flop_counter import FlopCounterMode

    from egom2p_torch.ops.vq import vq_lookup
    from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config
    tok = seq_vqvae_from_config(domain, torch.Generator().manual_seed(0), dim=64, depth=2,
                                num_heads=2, latent_dim=8, codebook_size=16)
    batch = 2
    x = torch.randn(batch, 60, channels + (domain == "gaze"))
    with FlopCounterMode(display=False) as counter:
        net = tok.net
        quant, _ = vq_lookup(net.quantize.cfg, net.quantize.state, net.encode_latents(x))
        net.decode_latents(quant)
    # training = forward + backward = 3 x the forward, per sample
    assert 3 * counter.get_total_flops() == batch * chip_smoke.seq_vqvae_train_flops(
        dim=64, depth=2, channels=channels, latent=8, codes=16)


def test_chip_smoke_clip_b16_copy_mirrors_the_yaml(tmp_path):
    """chip_smoke.py's JSON copy of cfgs/vqvae/clip_b16.yaml (its feature
    VQ-VAE phase reads it on a machine without PyYAML) equals the file key
    for key, and both give the VQ-VAE trainer the same settings."""
    yaml = pytest.importorskip("yaml")
    from egom2p_torch.cli import run_training_vqvae
    path = REPO / "cfgs/vqvae/clip_b16.yaml"
    assert chip_smoke.CLIP_B16_CONFIG == yaml.safe_load(path.read_text())
    by_yaml = vars(run_training_vqvae.get_args(["--config", str(path)]))
    json_path = tmp_path / "clip_b16.json"
    json_path.write_text(json.dumps(chip_smoke.CLIP_B16_CONFIG))
    by_json = vars(run_training_vqvae.get_args(["--config", str(json_path)]))
    assert {k: v for k, v in by_yaml.items() if k != "config"} == \
        {k: v for k, v in by_json.items() if k != "config"}


def test_chip_smoke_video_vqvae_flops_count_the_forward_products():
    """video_vqvae_flops_per_sample is 3 x the forward's products that
    torch's FLOP counter sees, at a small size: the tubelet patchify, the
    blocks and their attention, the quant projections, the codebook lookup
    and the unpatchify."""
    from torch.utils.flop_counter import FlopCounterMode

    from egom2p_torch.ops.vq import vq_lookup
    from egom2p_torch.tokenizers.video_vqvae import video_vqvae_from_config
    kw = dict(frames=4, size=32, tubelet=2, patch=8, dim=48, depth=2, latent=8, codes=16)
    tok = video_vqvae_from_config("rgb", torch.Generator().manual_seed(0), num_frames=4,
                                  image_size=32, tubelet_t=2, patch_size=8, dim=48, depth=2,
                                  num_heads=4, latent_dim=8, codebook_size=16)
    x = torch.randn(2, 4, 32, 32, 3)
    with FlopCounterMode(display=False) as counter:
        net = tok.net
        quant, _ = vq_lookup(net.quantize.cfg, net.quantize.state, net.encode_latents(x))
        net.decode_latents(quant)
    assert 3 * counter.get_total_flops() == 2 * chip_smoke.video_vqvae_flops_per_sample(**kw)


def test_world_size_two_with_an_unreachable_rendezvous_raises(tmp_path):
    """WORLD_SIZE=2 whose rendezvous no process serves (rank 1, a local
    port nobody listens on): init_distributed_mode raises within its
    timeout; the process never goes on to train alone."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from egom2p_torch.core import distributed\n"
            "try:\n"
            "    distributed.init_distributed_mode('cpu', timeout_s=3)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__)\n"
            "else:\n"
            "    print('formed', distributed.world_size())\n")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "RANK": "1", "WORLD_SIZE": "2",
           "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.stdout.startswith("raised"), proc.stdout + proc.stderr


def _imports(path):
    """[(module, enclosing function name or None)] of a source's imports."""
    import ast
    tree = ast.parse(path.read_text())
    scopes = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in ast.walk(node):
                scopes.setdefault(id(child), node.name)
    out = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        out += [(n, scopes.get(id(node))) for n in names]
    return out


def test_no_port_module_imports_opencv():
    """The SAM polygons are the port's own raster and inside test
    (data/modality_transforms.py): no source of the port imports cv2."""
    found = [str(p.relative_to(REPO)) for p in PORT_FILES + [REPO / "chip_smoke.py"]
             if p.suffix == ".py" and any(m.split(".")[0] == "cv2" for m, _ in _imports(p))]
    assert not found, found


def test_pillow_is_imported_only_inside_the_image_readers():
    """Pixels are computed with torch and numpy (data/rand_augment.py,
    data/resample.py); Pillow decodes and encodes image files only, inside
    the readers and the writer, never at module level."""
    found = {(str(p.relative_to(REPO)), fn) for p in PORT_FILES + [REPO / "chip_smoke.py"]
             if p.suffix == ".py" for m, fn in _imports(p) if m.split(".")[0] == "PIL"}
    assert found == {("egom2p_torch/data/modality_transforms.py", "image_loader"),
                     ("egom2p_torch/cli/tokenize_images.py", "read_image"),
                     ("egom2p_torch/cli/tokenize_images.py", "write_image")}, found
