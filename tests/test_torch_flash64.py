"""flash64 in the PyTorch port against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version
(`flash64_attention_reference`); the JAX side runs the real Pallas kernel in
interpret mode.  Inputs come from numpy with a fixed seed.  Both softmax
modes, with fully blocked rows, ragged edges and strided q/k/v views.
"""
import pathlib
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.ops import _build
from egom2p_torch.ops.attention import masked_attention
from egom2p_torch.ops.flash64 import (flash64_attention,
                                      flash64_attention_reference)
from egom2p_tpu.ops.flash64 import flash64_attention as jax_flash64

torch.set_num_threads(2)

# bf16 outputs of the same math, summed in another order: about one bf16 ulp
ATOL = RTOL = 1e-2


def _inputs(rng, B, N, M, H, mask_kind):
    C = H * 64
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    kv = rng.standard_normal((B, M, 2 * C)).astype(np.float32)
    blocked = None
    if mask_kind == "padding":
        blocked = np.arange(M)[None] >= np.array([[M - 37], [M // 3]])
    elif mask_kind == "all":
        blocked = np.ones((B, M), bool)
    elif mask_kind == "rows":
        blocked = rng.uniform(size=(B, M)) > 0.5
        blocked[1] = True
    return qkv, kv, blocked


@pytest.mark.parametrize("safemax", [False, True])
@pytest.mark.parametrize("N,M,mask_kind", [
    (256, 256, "none"),
    (300, 700, "padding"),   # ragged q and kv edges
    (256, 256, "all"),       # every key blocked (CFG's emptied encoder)
    (260, 333, "rows"),      # one batch row fully blocked
])
def test_flash64_plain_matches_jax_kernel(safemax, N, M, mask_kind):
    rng = np.random.default_rng(0)
    B, H = 2, 2
    C = H * 64
    qkv, kv, blocked = _inputs(rng, B, N, M, H, mask_kind)
    # the port takes views of the fused projections; JAX takes the slices
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    tblocked = None if blocked is None else torch.from_numpy(blocked)
    launches = flash64_attention.launches
    out = flash64_attention(tq[..., :C], tkv[..., :C], tkv[..., C:], tblocked,
                            safemax=safemax)
    assert flash64_attention.launches == launches, "CPU tensors take the plain version"
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, C)

    jq = jnp.asarray(qkv[..., :C], jnp.bfloat16)
    jk = jnp.asarray(kv[..., :C], jnp.bfloat16)
    jv = jnp.asarray(kv[..., C:], jnp.bfloat16)
    ref = jax_flash64(jq, jk, jv, None if blocked is None else jnp.asarray(blocked),
                      interpret=True, safemax=safemax)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=ATOL, rtol=RTOL)
    if blocked is not None:
        dead = blocked.all(axis=1)
        assert (out.float().numpy()[dead] == 0).all(), "blocked rows must be exact zeros"
        assert (ref[dead] == 0).all()


@pytest.mark.parametrize("safemax", [False, True])
def test_flash64_plain_matches_dense_softmax(safemax):
    """Both softmax forms equal the ordinary masked softmax (inside the clamp
    contract), through the port's dense masked_attention."""
    rng = np.random.default_rng(1)
    B, N, M, H = 2, 600, 130, 2  # N > REF_Q_CHUNK: two chunks
    qkv, kv, blocked = _inputs(rng, B, N, M, H, "padding")
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in (qkv[..., :128], kv[..., :128], kv[..., 128:]))
    out = flash64_attention_reference(q, k, v, torch.from_numpy(blocked), safemax=safemax)

    def heads(t):
        return t.float().unflatten(-1, (H, 64)).transpose(1, 2)

    dense = masked_attention(heads(q), heads(k), heads(v),
                             torch.from_numpy(blocked)[:, None, None, :])
    dense = dense.transpose(1, 2).flatten(-2)
    torch.testing.assert_close(out.float(), dense, atol=ATOL, rtol=RTOL)


def test_flash64_float32_in_float32_out():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 128)).astype(np.float32))
               for _ in range(3))
    out = flash64_attention(q, k, v)
    assert out.dtype == torch.float32
    # the kernel's output is bf16, cast back to q's dtype
    assert torch.equal(out, out.to(torch.bfloat16).float())


def test_flash64_safemax_env(monkeypatch):
    """safemax=None reads EGOM2P_F64_SAFEMAX, like the JAX wrapper.  A score
    above the clamp (80 exp2 units) tells the two forms apart."""
    q = torch.zeros((1, 2, 64))
    q[0, :, 0] = 30.0
    k = torch.zeros((1, 2, 64))
    k[0, 0, 0] = 30.0  # key 0: s = 900/8*log2e ~ 162 > 80; key 1: s = 0
    v = torch.zeros((1, 2, 64))
    v[0, 1, 0] = 1.0
    clamp = flash64_attention(q, k, v)
    monkeypatch.setenv("EGOM2P_F64_SAFEMAX", "1")
    safe = flash64_attention(q, k, v)
    assert safe[0, 0, 0] == 0.0    # softmax: key 1 weighs 2^-162, below fp32
    assert clamp[0, 0, 0] > 0.0     # the clamp caps key 0 at 2^80: key 1 weighs 2^-80
    monkeypatch.setenv("EGOM2P_F64_SAFEMAX", "0")
    assert torch.equal(flash64_attention(q, k, v), clamp)


def test_flash64_rejects_what_the_kernel_cannot_take():
    q = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError):
        flash64_attention(q[..., :96], q[..., :96], q[..., :96])  # head_dim != 64
    with pytest.raises(ValueError):
        flash64_attention(q, torch.zeros((1, 9, 64)), torch.zeros((1, 9, 64)))
    with pytest.raises(ValueError):
        flash64_attention(q, q, q, torch.zeros((1, 7), dtype=torch.bool))
    with pytest.raises(TypeError):
        flash64_attention(q.long(), q, q)
    with pytest.raises(RuntimeError):
        flash64_attention(*(torch.zeros((1, 8, 128), device="meta") for _ in range(3)))


def test_build_signature_matches_source():
    """The ctypes argtypes list matches the C entry point's parameter count
    (checked without nvcc, which the CPU machine lacks)."""
    src = "".join(p.read_text() for p in _build.sources())
    for name, (argtypes, _) in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, f"{name} not found in csrc"
        assert len(m.group(1).split(",")) == len(argtypes)
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_hash())


def test_port_imports_no_jax():
    """A fresh interpreter imports the port's whole slice without loading
    JAX, flax or the JAX package."""
    mods = ["egom2p_torch", "egom2p_torch.ops.flash64", "egom2p_torch.ops.attention",
            "egom2p_torch.ops.wavelet", "egom2p_torch.ops.fsq", "egom2p_torch.ops._build",
            "egom2p_torch.models.transformer", "egom2p_torch.models.embeddings",
            "egom2p_torch.models.egom2p", "egom2p_torch.generate.schedules",
            "egom2p_torch.generate.sampler", "egom2p_torch.tokenizers.cosmos.layers",
            "egom2p_torch.tokenizers.cosmos.network", "egom2p_torch.tokenizers.cosmos.video_api",
            "egom2p_torch.compat.from_jax", "egom2p_torch.cli.eval_common"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in ('jax', 'flax', 'egom2p_tpu') if m in sys.modules]\n"
            + "assert not bad, bad\n")
    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device, and alone in a directory, chip_smoke.py exits
    nonzero and prints no result."""
    script = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    for cwd, path in ((script.parent, script), (tmp_path, tmp_path / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
