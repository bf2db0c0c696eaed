"""Rules of the PyTorch port that hold on any machine: what its sources may
name, what its kernel wrappers refuse before a launch, and the bounds that
chip_smoke.py prints beside each kernel's time.  No CUDA device is needed.
"""
import pathlib
import re
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import egom2p_torch.ops.flash_ce as fce  # noqa: E402
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
    """The head_dim-64 forward is the wgmma kernel and holds no mma.sync
    product; the head_dim-80 instance has its own file and entry point."""
    csrc = REPO / "egom2p_torch" / "csrc"
    fwd64, fwd80 = (csrc / "flash64_fwd.cu").read_text(), (csrc / "flash80_fwd.cu").read_text()
    assert "wgmma_ss" in fwd64 and "wgmma_rs" in fwd64 and "tma_load_3d" in fwd64
    assert "mma_16816" not in fwd64 and "cp_async16" not in fwd64
    assert "mma_16816" in fwd80 and 'extern "C" int egom2p_flash80_fwd' in fwd80
    assert "wgmma_ss" in (csrc / "flash_ce_bwd.cu").read_text()


def test_backward_kernel_sources_are_split_by_head_dim():
    """The head_dim-64 backward (dq, dk/dv, fused) is on wgmma and TMA and
    holds no mma.sync product and no cp.async tile load; the head_dim-80
    fused backward keeps the mma.sync design in its own file with its own
    entry point, which the launcher picks by head_dim."""
    csrc = REPO / "egom2p_torch" / "csrc"
    bwd64, bwd80 = (csrc / "flash64_train.cu").read_text(), (csrc / "flash80_bwd.cu").read_text()
    for name in ("wgmma_ss", "wgmma_rs", "tma_load_3d", "tma_reduce_add_3d", "setmaxnreg_inc"):
        assert name in bwd64, name
    assert "mma_16816" not in bwd64 and "cp_async16" not in bwd64 and "atomicAdd" not in bwd64
    for entry in ("egom2p_flash64_train_dq", "egom2p_flash64_train_dkv",
                  "egom2p_flash64_train_dqkv"):
        assert f'extern "C" int {entry}(' in bwd64
    assert "mma_16816" in bwd80 and 'extern "C" int egom2p_flash80_bwd(' in bwd80
    assert "wgmma" not in bwd80.split('#include "common.cuh"')[1]
    launcher = (REPO / "egom2p_torch" / "ops" / "flash64_train.py").read_text()
    assert "lib.egom2p_flash80_bwd if hd == 80 else lib.egom2p_flash64_train_dqkv" in launcher


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


@pytest.mark.parametrize("D", [128, 384, 1024])
def test_ce_backward_kernel_dims_it_cannot_take_raise(D):
    """The CE backward kernel takes D in multiples of 256 up to 768 (one
    warpgroup per 256 output columns); the launcher raises before any
    launch on what it does not take."""
    y, w = torch.zeros((4, D)), torch.zeros((16, D))
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 256"):
        fce._launch_bwd(y, w, t, torch.ones(4), torch.zeros(4))
