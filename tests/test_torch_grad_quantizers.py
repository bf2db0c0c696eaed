"""The gradient quantizers and the residual / lookup-free FSQ on the port
(egom2p_torch/ops/{quantizers,fsq}.py) against the JAX package's
(egom2p_tpu/ops/{quantizers,fsq}.py), on seeded numpy inputs with the JAX
weights carried over:

* ResidualFSQ and LFQ: indices and codes bitwise, and the straight-through
  gradient;
* the taming VQ at legacy True and False, with use_norm, and with the
  'random' (JAX's draws passed in), 'extra' and integer remaps of unknown
  codes: indices equal, the losses within LOSS_RTOL, the gradients with
  respect to z and the codebook within GRAD_TOL of their largest magnitude
  against jax.grad; get_codebook_entry and the perplexity;
* Memcodes with 1 and 2 heads, at eval and in training with JAX's gumbel
  draws passed in: indices equal, the output and the gradients within
  GRAD_TOL of their largest magnitude; indices_to_embedding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.ops import fsq as tfsq
from egom2p_torch.ops.quantizers import Memcodes, TamingVectorQuantizer
from egom2p_tpu.ops import fsq as jfsq
from egom2p_tpu.ops import quantizers as jq

torch.set_num_threads(2)

LOSS_RTOL = 1e-6   # means of fp32 squares of O(1) values in another order
GRAD_TOL = 1e-5    # of each gradient's largest magnitude
K, D = 24, 8


def _grad(t):
    """t's gradient, zeros where autograd reached none (an argmax path)."""
    return (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    err = err / scale if scale > 1e-30 else err
    assert err <= tol, f"{what}: {err:.2e} of its max"


def test_residual_fsq_and_lfq_bitwise():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((2, 5, 7, 6)) * 2).astype(np.float32)
    j_idx, j_codes = jfsq.ResidualFSQ((8, 8, 8, 5, 5, 5), 3)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    t_idx, t_codes = tfsq.ResidualFSQ((8, 8, 8, 5, 5, 5), 3)(zt)
    assert tuple(t_idx.shape) == (2, 3, 5, 7) and t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_codes.detach().numpy(), np.asarray(j_codes))
    back = tfsq.ResidualFSQ((8, 8, 8, 5, 5, 5), 3).indices_to_codes(t_idx)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jfsq.ResidualFSQ((8, 8, 8, 5, 5, 5), 3).indices_to_codes(j_idx)))
    # straight-through: the first stage's bounded latent passes its gradient on
    t_codes.sum().backward()
    jg = jax.grad(lambda x: jfsq.ResidualFSQ((8, 8, 8, 5, 5, 5), 3)(x)[1].sum())(jnp.asarray(z))
    _close(zt.grad.numpy(), jg, GRAD_TOL, "ResidualFSQ gradient")

    zl = rng.standard_normal((3, 4, 10)).astype(np.float32)
    j_idx, j_codes = jfsq.LFQ(10)(jnp.asarray(zl))
    zt = torch.from_numpy(zl).requires_grad_(True)
    t_idx, t_codes = tfsq.LFQ(10)(zt)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_codes.detach().numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(tfsq.LFQ(10).indices_to_codes(t_idx).numpy(),
                                  np.asarray(jfsq.LFQ(10).indices_to_codes(j_idx)))
    (t_codes * 3).sum().backward()
    np.testing.assert_array_equal(zt.grad.numpy(), np.full_like(zl, 3.0))


TAMING_CASES = {
    "legacy": dict(legacy=True),
    "not_legacy": dict(legacy=False),
    "use_norm": dict(use_norm=True),
    "remap_random": dict(remap=tuple(range(0, K, 3)), unknown_index="random"),
    "remap_extra": dict(remap=tuple(range(0, K, 3)), unknown_index="extra"),
    "remap_int": dict(remap=tuple(range(0, K, 3)), unknown_index=1),
}


@pytest.mark.parametrize("case", list(TAMING_CASES))
def test_taming_matches_jax(case):
    kw = dict(beta=0.3, **TAMING_CASES[case])
    rng = np.random.default_rng(1)
    embed = rng.uniform(-1, 1, (K, D)).astype(np.float32)
    z = rng.standard_normal((3, 10, D)).astype(np.float32)
    w = rng.standard_normal((3, 10, D)).astype(np.float32)
    jm = jq.TamingVectorQuantizer(K, D, **kw)
    params = {"params": {"embedding": jnp.asarray(embed)}}
    key = jax.random.PRNGKey(3)

    def jloss(params, z):
        z_q, loss, aux = jm.apply(params, z, True, key)
        return loss + jnp.sum(z_q * w), (z_q, loss, aux)

    (_, (jz_q, jl, (ji, jc, je, jp))), (jgp, jgz) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))

    tm = TamingVectorQuantizer(K, D, **kw)
    with torch.no_grad():
        tm.embedding.weight.copy_(torch.from_numpy(embed))
    draws = None
    if kw.get("unknown_index") == "random":
        draws = torch.from_numpy(np.array(jax.random.randint(key, (3, 10), 0, len(kw["remap"]))))
    zt = torch.from_numpy(z).requires_grad_(True)
    tz_q, tl, (ti, tc, te, tp) = tm(zt, remap_draws=draws)
    (tl + (tz_q * torch.from_numpy(w)).sum()).backward()

    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if "remap" in kw:  # some codes fall outside the used list
        assert (np.asarray(ji) >= len(kw["remap"])).any() or case != "remap_extra"
    np.testing.assert_array_equal(tz_q.detach().numpy(), np.asarray(jz_q))
    for name, t, j in (("loss", tl, jl), ("commit", tc, jc), ("emb_loss", te, je),
                       ("perplexity", tp, jp)):
        np.testing.assert_allclose(t.item(), float(j), rtol=LOSS_RTOL, err_msg=name)
    _close(zt.grad.numpy(), jgz, GRAD_TOL, "dz")
    _close(tm.embedding.weight.grad.numpy(), jgp["params"]["embedding"], GRAD_TOL, "dcodebook")
    got = tm.get_codebook_entry(ti)
    want = jm.apply(params, ji, method=jq.TamingVectorQuantizer.get_codebook_entry)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_memcodes_matches_jax(heads, training):
    rng = np.random.default_rng(2)
    hd = D // heads
    params = {"codes": rng.standard_normal((heads, K, hd)).astype(np.float32),
              "to_k": (rng.standard_normal((heads, hd, hd)) / np.sqrt(hd)).astype(np.float32),
              "to_v": (rng.standard_normal((heads, hd, hd)) / np.sqrt(hd)).astype(np.float32)}
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    w = rng.standard_normal((2, 12, D)).astype(np.float32)
    jm = jq.Memcodes(D, K, heads=heads, temperature=0.7)
    key = jax.random.PRNGKey(4)

    def jfwd(p, x):
        out, _, ind = jm.apply({"params": p}, x, training, key if training else None)
        return jnp.sum(out * w), (out, ind)

    (_, (jout, jind)), (jgp, jgx) = jax.value_and_grad(jfwd, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    tm = Memcodes(D, K, heads=heads, temperature=0.7)
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(torch.from_numpy(v))
    noise = None
    if training:  # the uniform draws of JAX's gumbel noise
        noise = torch.from_numpy(np.array(jax.random.uniform(
            key, (2, heads, 12, K), minval=1e-9, maxval=1.0 - 1e-9)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tout, tloss, tind = tm(xt, training, noise=noise)
    (tout * torch.from_numpy(w)).sum().backward()
    assert float(tloss) == 0.0
    assert tuple(tind.shape) == ((2, 12) if heads == 1 else (2, heads, 12))
    np.testing.assert_array_equal(tind.numpy(), np.asarray(jind))
    _close(tout.detach().numpy(), jout, GRAD_TOL, "out")
    _close(_grad(xt), jgx, GRAD_TOL, "dx")  # zero at eval, as JAX's
    for k in params:
        _close(_grad(getattr(tm, k)), jgp[k], GRAD_TOL, f"d{k}")
    emb = tm.indices_to_embedding(tind)
    want = jm.apply({"params": {k: jnp.asarray(v) for k, v in params.items()}}, jind,
                    method=jq.Memcodes.indices_to_embedding)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    if not training:  # the eval output is the embedding of its indices
        np.testing.assert_allclose(tout.detach().numpy(), emb.detach().numpy(), atol=1e-6)


def test_quantizer_inits_follow_jax():
    """uniform +-1/n codebook; normal(1) codes; lecun-normal (truncated,
    fan_in hd x heads) to_k / to_v, as flax draws them."""
    g = torch.Generator().manual_seed(0)
    tm = TamingVectorQuantizer(512, 16).init_random_(g)
    e = tm.embedding.weight
    assert float(e.abs().max()) <= 1 / 512 and float(e.std()) > 0.4 / 512
    mc = Memcodes(64, 256, heads=2).init_random_(g)
    assert abs(float(mc.codes.std()) - 1.0) < 0.05
    jp = jq.Memcodes(64, 256, heads=2).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 64)))
    for k in ("to_k", "to_v"):
        j = np.asarray(jp["params"][k])
        t = getattr(mc, k).detach().numpy()
        assert abs(t.std() / j.std() - 1) < 0.1, k
        assert np.abs(t).max() <= 2.0 * t.std() / 0.8796 + 1e-6
