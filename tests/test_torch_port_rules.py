"""Rules of the PyTorch port that hold on any machine: what its sources may
name, what its kernel wrappers refuse before a launch, and the bounds that
chip_smoke.py prints beside each kernel's time.  No CUDA device is needed.
"""
import itertools
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

PORT_FILES = sorted(p for p in (REPO / "egom2p_torch").rglob("*")
                    if p.suffix in (".py", ".cu", ".cuh") and "build" not in p.parts)


@pytest.mark.parametrize("pattern,what", [
    (r"scaled_dot_product_attention", "PyTorch's fused attention"),
    (r"^\s*(import|from)\s+jax\b", "an import of JAX"),
    (r"^\s*(import|from)\s+flax\b", "an import of flax"),
    (r"^\s*(import|from)\s+egom2p_tpu\b", "an import of the JAX package"),
    (r"torch\.compile\(", "torch.compile"),
])
def test_port_sources_do_not_name(pattern, what):
    """No file of the port calls a library's attention, compiles its plain
    versions, or imports JAX or the JAX package (docstrings may name the JAX
    files a module mirrors)."""
    assert len(PORT_FILES) > 40
    rx = re.compile(pattern, re.MULTILINE)
    found = [str(p.relative_to(REPO)) for p in PORT_FILES if rx.search(p.read_text())]
    assert not found, f"{what} in {found}"


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
