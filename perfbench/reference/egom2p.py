"""Plain fp32 reference of the EgoM2P encoder-decoder: token and positional
embeddings, pre-norm encoder blocks, decoder blocks (self-attention,
cross-attention, SwiGLU MLP), the tied vocab heads, the pretraining loss
and one ROAR step's guided logits.

Written from the model's equations (reference: egom2p/models/egom2p_model.py
57-819, egom2p_utils.py:118-412; the port's egom2p_torch/models/*.py take the
same parameter names, which a seeded weight set fills on both sides).  It
imports nothing of the port.  Departures from the port, none of which
changes the mathematics: every product and softmax runs in fp32 (TF32 off;
the caller's `tf32` context), attention is the dense softmax over exactly
the live tokens of one batch row (no padding buckets, no kernels), and the
per-modality decoder self-attention mask of training is a dense boolean
mask.

`quant` rounds both operands of every product to a lower precision (the
control: fp8 e4m3 with a per-tensor scale, `fp8_round`).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def sincos_1d(n: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    pos = np.arange(n, dtype=np.float32)
    omega = 1.0 / temperature ** (np.arange(dim // 2, dtype=np.float32) / (dim // 2))
    out = np.einsum("n,d->nd", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d(t: int, h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(t*h*w, dim): per axis `dim // 6 * 2` interleaved sin / cos channels,
    time then height then width, zero-padded to `dim`
    (reference: egom2p_utils.py:63-86)."""
    ch = int(dim // 6 * 2)
    inv_freq = 1.0 / temperature ** (np.arange(0, ch, 2, dtype=np.float32) / ch)

    def axis(n):
        s = np.einsum("i,j->ij", np.arange(n, dtype=np.float32), inv_freq)
        return np.stack([np.sin(s), np.cos(s)], axis=-1).reshape(n, -1)

    emb = np.zeros((t, h, w, dim), dtype=np.float32)
    emb[..., :ch] = axis(t)[:, None, None, :]
    emb[..., ch:2 * ch] = axis(h)[None, :, None, :]
    emb[..., 2 * ch:3 * ch] = axis(w)[None, None, :, :]
    return emb.reshape(t * h * w, dim)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448), back
    in fp32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class EgoM2PReference:
    """`params`: name -> fp32 tensor, the port's parameter names.  `config`:
    the configuration file's `model` section (dim, heads, depths, MLP
    hidden).  `modalities`: name -> {"vocab_size", "grid"} of the four
    token modalities."""

    def __init__(self, params: Dict[str, torch.Tensor], config: Dict,
                 modalities: Dict[str, Dict], quant: Optional[Callable] = None,
                 remat: bool = False):
        self.p = params
        self.dim = config["dim"]
        self.heads = config["num_heads"]
        self.enc_depth = config["encoder_depth"]
        self.dec_depth = config["decoder_depth"]
        self.mods = modalities
        self.quant = quant
        self.remat = remat
        device = next(iter(params.values())).device
        self.pos = {}
        for mod, info in modalities.items():
            grid = info["grid"]
            table = sincos_3d(*grid, self.dim) if len(grid) == 3 else sincos_1d(grid[0], self.dim)
            self.pos[mod] = torch.from_numpy(table).to(device)

    # ---------------------------------------------------------- primitives
    def _mm(self, a, b):
        if self.quant is not None:
            a, b = self.quant(a), self.quant(b)
        return a @ b

    def _linear(self, x, name):
        y = self._mm(x, self.p[name + ".weight"].t())
        bias = self.p.get(name + ".bias")
        return y if bias is None else y + bias

    def _norm(self, x, name):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + EPS) * self.p[name + ".weight"]
        bias = self.p.get(name + ".bias")
        return y if bias is None else y + bias

    def _attention(self, q, k, v, blocked=None):
        """(N, D) q and (M, D) k, v over `heads`; `blocked` (N, M) True =
        masked."""
        H = self.heads
        q, k, v = (t.unflatten(-1, (H, -1)).transpose(0, 1) for t in (q, k, v))
        s = self._mm(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5
        if blocked is not None:
            s = s.masked_fill(blocked[None], float("-inf"))
        o = self._mm(torch.softmax(s, dim=-1), v)
        return o.transpose(0, 1).flatten(1)

    def _mlp(self, x, name):
        return self._linear(F.silu(self._linear(x, name + ".fc1")) * self._linear(x, name + ".fc3"),
                            name + ".fc2")

    # -------------------------------------------------------------- blocks
    def _enc_block(self, i, x):
        n = f"encoder.{i}"
        h = self._norm(x, n + ".norm1")
        q, k, v = self._linear(h, n + ".attn.qkv").chunk(3, dim=-1)
        x = x + self._linear(self._attention(q, k, v), n + ".attn.proj")
        return x + self._mlp(self._norm(x, n + ".norm2"), n + ".mlp")

    def _dec_block(self, i, y, context, blocked):
        n = f"decoder.{i}"
        h = self._norm(y, n + ".norm1")
        q, k, v = self._linear(h, n + ".self_attn.qkv").chunk(3, dim=-1)
        y = y + self._linear(self._attention(q, k, v, blocked), n + ".self_attn.proj")
        q = self._linear(self._norm(y, n + ".query_norm"), n + ".cross_attn.q")
        if context.shape[0] > 0:
            k, v = self._linear(self._norm(context, n + ".context_norm"),
                                n + ".cross_attn.kv").chunk(2, dim=-1)
            y = y + self._linear(self._attention(q, k, v), n + ".cross_attn.proj")
        # no live context: every key is blocked and the cross-attention adds nothing
        return y + self._mlp(self._norm(y, n + ".norm2"), n + ".mlp")

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ------------------------------------------------------------- passes
    def _emb(self, mod, positions):
        return self.pos[mod][positions] + self.p[f"encoder_embeddings.{mod}.mod_emb"][0, 0]

    def encode(self, visible: Dict[str, tuple]):
        """One batch row's encoder pass over its visible tokens: `visible`
        maps a modality to (positions (n,) long, token ids (n,) long).
        Returns the context (n_total, D) fed to every decoder block."""
        xs, embs = [], []
        for mod in sorted(visible):
            pos, ids = visible[mod]
            xs.append(self.p[f"encoder_embeddings.{mod}.token_emb.weight"][ids])
            embs.append(self._emb(mod, pos))
        if not xs:
            return torch.zeros(0, self.dim, device=self.p["mask_token"].device)
        emb = torch.cat(embs)
        x = torch.cat(xs) + emb
        for i in range(self.enc_depth):
            x = self._run(self._enc_block, i, x)
        x = self._norm(x, "encoder_norm")
        return self._linear(x, "decoder_proj_context") + emb

    def decode(self, queries: Dict[str, torch.Tensor], context, segmented: bool):
        """One batch row's decoder pass over the target positions `queries`
        (modality -> positions (k,) long), in sorted modality order.
        Self-attention stays within a modality when `segmented`.  Returns
        the hidden states (k_total, D)."""
        mods = sorted(queries)
        y = torch.cat([self._emb(m, queries[m]) for m in mods]) + self.p["mask_token"][0, 0]
        blocked = None
        if segmented and len(mods) > 1:
            seg = torch.cat([torch.full((len(queries[m]),), i, device=y.device)
                             for i, m in enumerate(mods)])
            blocked = seg[:, None] != seg[None, :]
        for i in range(self.dec_depth):
            y = self._run(self._dec_block, i, y, context, blocked)
        return self._norm(y, "decoder_norm")

    def logits(self, mod, hidden):
        """fp32 logits of modality `mod`'s tied head."""
        return self._mm(hidden, self.p[f"decoder_embeddings.{mod}.token_emb.weight"].t())

    # --------------------------------------------------------------- tasks
    def row_ce_sums(self, row: Dict[str, Dict[str, np.ndarray]], max_in: int, max_tgt: int):
        """One masked batch row (a mod dict of numpy arrays: tensor,
        input_mask, target_mask; False = visible / target) -> {mod: CE summed
        over its targets}.  The encoder keeps the first `max_in` visible
        tokens and the decoder the first `max_tgt` targets, in sorted
        modality order, as the model's argsort-gather does."""
        device = self.p["mask_token"].device
        visible, queries, targets = {}, {}, {}
        left_in, left_tgt = max_in, max_tgt
        for mod in sorted(row):
            d = row[mod]
            ids = np.asarray(d["tensor"]).reshape(-1)
            vis = np.flatnonzero(~np.asarray(d["input_mask"]))[:left_in]
            tgt = np.flatnonzero(~np.asarray(d["target_mask"]))[:left_tgt]
            left_in -= len(vis)
            left_tgt -= len(tgt)
            if len(vis):
                visible[mod] = (torch.from_numpy(vis).to(device),
                                torch.from_numpy(ids[vis].astype(np.int64)).to(device))
            if len(tgt):
                queries[mod] = torch.from_numpy(tgt).to(device)
                targets[mod] = torch.from_numpy(ids[tgt].astype(np.int64)).to(device)
        if not queries:  # a row can draw no target: it adds nothing to the loss
            return {}
        context = self.encode(visible)
        hidden = self.decode(queries, context, segmented=True)
        out, start = {}, 0
        for mod in sorted(queries):
            k = len(queries[mod])
            lg = self.logits(mod, hidden[start:start + k])
            out[mod] = (torch.logsumexp(lg, dim=-1)
                        - lg.gather(1, targets[mod][:, None])[:, 0]).sum()
            start += k
        return out

    def guided_logits(self, cond: Dict[str, tuple], known: Dict[str, tuple], target: str,
                      positions: torch.Tensor, cfg_scale: float) -> torch.Tensor:
        """One ROAR step of one batch row under classifier-free guidance:
        the conditional pass sees `cond` and the target tokens already
        generated (`known`), the unconditional pass `known` alone; the
        decoder queries `positions` of `target`.  Returns the guided fp32
        logits l_u + s (l_c - l_u), (k, V)."""
        out = []
        for visible in ({**cond, **known}, dict(known)):
            context = self.encode(visible)
            hidden = self.decode({target: positions}, context, segmented=False)
            out.append(self.logits(target, hidden))
        lc, lu = out
        return lu + cfg_scale * (lc - lu)


def egom2p_shapes(model: Dict, modalities: Dict[str, Dict]) -> Dict[str, tuple]:
    """Every parameter's name and shape, the port's names (the decoder
    shares the encoder's modality embeddings; norms carry no bias in the
    bias-free models; decoder_proj_context keeps its bias)."""
    D, F = model["dim"], model["mlp_hidden"]
    out = {"mask_token": (1, 1, D), "decoder_proj_context.weight": (D, D),
           "decoder_proj_context.bias": (D,), "encoder_norm.weight": (D,),
           "decoder_norm.weight": (D,)}
    for mod, info in modalities.items():
        out[f"encoder_embeddings.{mod}.token_emb.weight"] = (info["vocab_size"], D)
        out[f"encoder_embeddings.{mod}.mod_emb"] = (1, 1, D)
        out[f"decoder_embeddings.{mod}.token_emb.weight"] = (info["vocab_size"], D)
    mlp = {"mlp.fc1.weight": (F, D), "mlp.fc3.weight": (F, D), "mlp.fc2.weight": (D, F),
           "norm1.weight": (D,), "norm2.weight": (D,)}
    for i in range(model["encoder_depth"]):
        out.update({f"encoder.{i}.{k}": s for k, s in mlp.items()})
        out[f"encoder.{i}.attn.qkv.weight"] = (3 * D, D)
        out[f"encoder.{i}.attn.proj.weight"] = (D, D)
    for i in range(model["decoder_depth"]):
        out.update({f"decoder.{i}.{k}": s for k, s in mlp.items()})
        out.update({f"decoder.{i}.self_attn.qkv.weight": (3 * D, D),
                    f"decoder.{i}.self_attn.proj.weight": (D, D),
                    f"decoder.{i}.query_norm.weight": (D,),
                    f"decoder.{i}.context_norm.weight": (D,),
                    f"decoder.{i}.cross_attn.q.weight": (D, D),
                    f"decoder.{i}.cross_attn.kv.weight": (2 * D, D),
                    f"decoder.{i}.cross_attn.proj.weight": (D, D)})
    return out


def adamw_reference(params: List[torch.Tensor], grads: List[torch.Tensor],
                    state: List[Dict], decayed: Sequence[bool], lr: float,
                    betas: Sequence[float], weight_decay: float, clip: float,
                    eps: float = 1e-8) -> List[torch.Tensor]:
    """Global-norm clipping (clip / (|g| + 1e-6) when |g| > clip) then AdamW
    with decoupled weight decay on the `decayed` leaves, in place on
    `params`.  Returns the clipped gradients, as the optimizer receives them."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
    clipped = [g * coef for g in grads]
    b1, b2 = betas
    for p, g, s, dec in zip(params, clipped, state, decayed):
        s["step"] = s.get("step", 0) + 1
        s["m"] = s.get("m", torch.zeros_like(p)) * b1 + g * (1 - b1)
        s["v"] = s.get("v", torch.zeros_like(p)) * b2 + g.square() * (1 - b2)
        t = s["step"]
        if dec:
            p.mul_(1 - lr * weight_decay)
        denom = s["v"].sqrt() / math.sqrt(1 - b2 ** t) + eps
        p.addcdiv_(s["m"], denom, value=-lr / (1 - b1 ** t))
    return clipped
