"""The port's LayerNorm (ops/layer_norm.py through models/transformer.py)
against the formula it replaced, written out here as the plain reference:
fp32 and bf16 parameters (a module cast whole to bf16, as the teachers are
run), a bf16 teacher, an empty input; what autograd keeps of one norm; the
backward kernel's launch plan.

CPU tensors take the plain route (ATen's native_layer_norm on an fp32 copy);
the kernels are held to the same numbers on the card in test_torch_gpu.py.
No JAX.
"""
import numpy as np
import pytest
import torch

import egom2p_torch.models.transformer as transformer
from egom2p_torch.models.teachers import TeacherSpec, ViTTeacher
from egom2p_torch.models.transformer import LayerNorm
from egom2p_torch.ops.layer_norm import SMEM_PER_BLOCK, bwd_plan

# bf16 outputs: the variance summed in another order moves an output across
# a rounding boundary now and then, by one bf16 ulp (at most 2^-7 of |y|)
BF16_ULP = 2.0 ** -7
# fp32: sums over D (up to 1020) terms and over the rows in another order
F32_RTOL = 1e-5
# a bf16 teacher's features, the old formula against the new: one-ulp
# differences of the norms' outputs carried through bf16 blocks
TEACHER_REL_L2 = 1e-2


def plain_layer_norm(x, weight, bias, eps):
    """The formula the port ran before (egom2p_utils.py:118-133): fp32
    mean, two-pass variance, rsqrt and affine, one rounding to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _inputs(shape, dtype, bias, seed=0):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    # a residual stream with an offset per row: the mean matters
    x = rng.standard_normal(shape, np.float32) * 2 + rng.standard_normal(shape[:-1] + (1,),
                                                                         np.float32)
    dy = rng.standard_normal(shape, np.float32)
    ln = LayerNorm(D, bias=bias)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(1 + 0.2 * rng.standard_normal(D, np.float32)))
        if bias:
            ln.bias.copy_(torch.from_numpy(0.2 * rng.standard_normal(D, np.float32)))
    return torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype), ln


def assert_within(got, want, rtol, what):
    """|got - want| <= rtol |want| + F32_RTOL max |want|, elementwise."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    bad = (got - want).abs() > rtol * want.abs() + F32_RTOL * scale
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.numel()} off, largest "
                           f"{(got - want).abs().max().item():.3g} (scale {scale:.3g})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 48, 768), (3, 40, 1020), (2, 16, 4, 64)],
                         ids=["768", "1020", "qk64"])
def test_layer_norm_matches_the_plain_formula(dtype, bias, shape):
    x, dy, ln = _inputs(shape, dtype, bias)
    xa = x.clone().requires_grad_()
    y = ln(xa)
    y.backward(dy)

    ref = LayerNorm(shape[-1], bias=bias)
    ref.load_state_dict(ln.state_dict())
    xr = x.clone().requires_grad_()
    yr = plain_layer_norm(xr, ref.weight, ref.bias, ref.eps)
    yr.backward(dy)

    assert y.dtype == dtype and xa.grad.dtype == dtype
    assert ln.weight.grad.dtype == torch.float32
    rtol = BF16_ULP if dtype == torch.bfloat16 else F32_RTOL
    assert_within(y, yr, rtol, "y")
    assert_within(xa.grad, xr.grad, rtol, "dx")
    # the parameters' gradients are fp32 sums of the same bf16 / fp32 terms
    assert_within(ln.weight.grad, ref.weight.grad, F32_RTOL, "dweight")
    if bias:
        assert_within(ln.bias.grad, ref.bias.grad, F32_RTOL, "dbias")
    else:
        assert ln.bias is None and set(ln.state_dict()) == {"weight"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_with_bf16_parameters_matches_the_plain_formula(dtype, bias):
    """A module cast whole to bf16 (the teachers at --teacher_dtype bf16):
    the parameters are cast to fp32 for the norm and their gradients come
    back in bf16, as the old formula's type promotion gave them."""
    x, dy, ln = _inputs((3, 40, 1020), dtype, bias)
    ln = ln.to(torch.bfloat16)
    ref = LayerNorm(1020, bias=bias).to(torch.bfloat16)
    ref.load_state_dict(ln.state_dict())
    xa, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = ln(xa)
    y.backward(dy)
    yr = plain_layer_norm(xr, ref.weight, ref.bias, ref.eps)
    yr.backward(dy)

    assert y.dtype == dtype and ln.weight.grad.dtype == torch.bfloat16
    rtol = BF16_ULP if dtype == torch.bfloat16 else F32_RTOL
    assert_within(y, yr, rtol, "y")
    assert_within(xa.grad, xr.grad, rtol, "dx")
    # the same fp32 sums, each rounded once to bf16: a sum order that moves
    # one across a rounding boundary moves it by one bf16 ulp
    assert_within(ln.weight.grad, ref.weight.grad, BF16_ULP, "dweight")
    if bias:
        assert_within(ln.bias.grad, ref.bias.grad, BF16_ULP, "dbias")


def test_teacher_cast_to_bf16_matches_the_plain_formula(monkeypatch):
    """A small ViT teacher cast whole to bf16 (run_training_vqvae's
    build_teacher at its default --teacher_dtype bf16) runs its norms with
    bf16 weights; its features agree with the same teacher on the plain
    formula.  Its bf16 blocks carry a norm's one-ulp differences on, so the
    features are compared by their relative L2 difference: TEACHER_REL_L2,
    a few bf16 ulps (2^-8 each) over the map."""
    spec = TeacherSpec(name="bf16-test", patch=8, width=128, depth=2, heads=2, feat_dim=128,
                       ln_pre=True, image_size=32)
    teacher = ViTTeacher(spec).init_random_(torch.Generator().manual_seed(0))
    teacher = teacher.to(torch.bfloat16).eval()
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        got = teacher(x).float()
        monkeypatch.setattr(transformer.LayerNorm, "forward",
                            lambda self, v: plain_layer_norm(v, self.weight, self.bias, self.eps))
        want = teacher(x).float()
    assert got.shape == (2, 4, 4, 128) and torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < TEACHER_REL_L2, rel


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_of_an_empty_input(bias):
    """No row: an empty output, and zero gradients for the parameters."""
    ln = LayerNorm(64, bias=bias)
    x = torch.empty((0, 7, 64), dtype=torch.bfloat16, requires_grad=True)
    y = ln(x)
    y.sum().backward()
    assert y.shape == x.shape and y.dtype == x.dtype and x.grad.shape == x.shape
    assert torch.equal(ln.weight.grad, torch.zeros(64))
    if bias:
        assert torch.equal(ln.bias.grad, torch.zeros(64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_saves_only_the_input_and_row_statistics(dtype, bias):
    """Autograd keeps, for one norm, at most x in its own dtype, two fp32
    values a row and the parameters: no fp32 copy of the activation."""
    shape = (4, 256, 1020)
    x, _, ln = _inputs(shape, dtype, bias)
    x.requires_grad_()
    saved = {}

    def pack(t):
        saved[(t.untyped_storage().data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ln(x)
    rows = x.numel() // shape[-1]
    params = sum(p.numel() * p.element_size() for p in ln.parameters())
    limit = x.numel() * x.element_size() + 2 * 4 * rows + params
    assert sum(saved.values()) <= limit, (sum(saved.values()), limit)
    assert all(d in (dtype, torch.float32) for _, d in saved)


@pytest.mark.parametrize("rows,dim", [(8192, 1020), (16384, 768), (196608, 64),
                                      (1, 1280), (5, 29056)])
def test_layer_norm_backward_plan(rows, dim):
    """One wave of blocks whose per-warp sums fit in shared memory."""
    blocks, warps = bwd_plan(rows, dim, 132)
    assert 1 <= warps <= 8 and 1 <= blocks <= -(-rows // warps)
    assert 8 * warps * dim <= SMEM_PER_BLOCK
    per_sm = -(-blocks // 132)
    assert per_sm * (8 * warps * dim + 1024) <= 228 * 1024 and per_sm * warps <= 64
    if dim <= 2048:
        assert warps == 8


def test_layer_norm_backward_plan_refuses_a_dim_beyond_shared_memory():
    with pytest.raises(ValueError, match="dim up to"):
        bwd_plan(64, SMEM_PER_BLOCK // 8 + 1, 132)
