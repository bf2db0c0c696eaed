"""The work the model does, counted where it calls attention and the loss,
whatever implements them: forward pre-hooks on every encoder and decoder
block record each call's shapes and masks, and a wrapper on the loss
records its live target rows.  Nothing is read back while the program
runs: the masks are kept and reduced to counts after the stretch.

Counts are at the live rows and keys (padding and dead targets left out):
- attention: 4 * rows * keys * head_dim FLOPs a head forward (two
  products), the backward 2.5 times that; bytes: q, k, v read and o
  written once in bf16 (forward), q, k, v, o, dO read and dQ, dK, dV
  written (backward);
- the CE forward: 2 * rows * dim * vocab FLOPs; y and the head read in
  bf16, two fp32 values a row written;
- model FLOPs: every product of the blocks and heads at the live tokens,
  the backward twice the forward, no recomputation.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

FWD, BWD = "fwd", "bwd"


def attention_cost(rows: float, keys_x_rows: float, keys: float, heads: int, hd: int,
                   backward: bool):
    """(flops, bytes) of one attention call over `rows` live queries and
    `keys` live keys, `keys_x_rows` the live (query, key) pairs."""
    fwd = 4.0 * keys_x_rows * hd * heads
    width = 2.0 * heads * hd  # bf16 bytes of one row over every head
    if not backward:
        return fwd, width * (2 * rows + 2 * keys)
    return 2.5 * fwd, width * (4 * rows + 4 * keys)


def bound_s(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bytes)


class WorkCounter:
    """Hooks on `model` (the port's EgoM2P).  `active` gates the records;
    `tag` labels them (the step or batch they belong to)."""

    def __init__(self, model, peaks: Dict[str, float]):
        self.model = model
        self.peak_flops = peaks["bf16_flops_per_s"]
        self.peak_bytes = peaks["hbm_bytes_per_s"]
        cfg = model.config
        self.dim, self.heads = cfg.dim, cfg.num_heads
        self.hd = cfg.dim // cfg.num_heads
        first = model.encoder[0].mlp
        self.ffn = first.fc1.out_features
        self.mod_ids = {m: model.mod_info[m]["id"] for m in model.out_domains}
        self.vocab = {m: model.mod_info[m]["vocab_size"] for m in model.out_domains}
        self.active = False
        self.tag = None
        self.records: List[tuple] = []
        self._handles = []
        for blk in model.encoder:
            self._handles.append(blk.register_forward_pre_hook(self._enc, with_kwargs=True))
        for blk in model.decoder:
            self._handles.append(blk.register_forward_pre_hook(self._dec, with_kwargs=True))
        self._loss = model.forward_loss

        def forward_loss(y, target_ids, decoder_mod_mask, loss_type, present_mods, *a, **k):
            if self.active:
                self.records.append((self.tag, "loss", decoder_mod_mask, tuple(present_mods),
                                     torch.is_grad_enabled()))
            return self._loss(y, target_ids, decoder_mod_mask, loss_type, present_mods, *a, **k)

        model.forward_loss = forward_loss

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self.model.__dict__.pop("forward_loss", None)
        self.records = []

    @staticmethod
    def _arg(args, kwargs, i, name):
        return args[i] if len(args) > i else kwargs.get(name)

    def _enc(self, module, args, kwargs):
        if self.active:
            x, mask = args[0], self._arg(args, kwargs, 1, "mask")
            self.records.append((self.tag, "enc", tuple(x.shape), mask, torch.is_grad_enabled()))

    def _dec(self, module, args, kwargs):
        if self.active:
            x, context = args[0], args[1]
            sa, xa = self._arg(args, kwargs, 2, "sa_mask"), self._arg(args, kwargs, 3, "xa_mask")
            self.records.append((self.tag, "dec", tuple(x.shape), tuple(context.shape), sa, xa,
                                 torch.is_grad_enabled()))

    # ---------------------------------------------------------- reduction
    @staticmethod
    def _live_keys(mask, B: int, M: int) -> torch.Tensor:
        """(B,) live keys of a key-padding mask (True = blocked), or M."""
        if mask is None:
            return torch.full((B,), float(M))
        if mask.dim() == 3:
            mask = mask[:, 0]
        elif mask.dim() == 4:
            mask = mask[:, 0, 0]
        return (~mask).sum(dim=-1).float().cpu()

    def _segments(self, sa, B: int, M: int):
        """(rows (B,), pairs (B,)) of the decoder self-attention: a segment
        mask counts the pairs within each live segment, none every pair."""
        if sa is None:
            return torch.full((B,), float(M)), torch.full((B,), float(M * M))
        seg = getattr(sa, "segments", None)
        if seg is None:  # a dense (B, M, M) mask, True = blocked
            live = (~sa).sum(dim=(-1, -2)).float().cpu()
            rows = (~sa).any(dim=-1).sum(dim=-1).float().cpu()
            return rows, live
        ids = torch.tensor(sorted(set(self.mod_ids.values())), device=seg.device)
        counts = (seg[..., None] == ids).sum(dim=1).float().cpu()  # (B, mods)
        return counts.sum(dim=1), counts.square().sum(dim=1)

    def reduce(self, tags: Optional[set] = None) -> Dict[str, float]:
        """Totals over the records whose tag is in `tags` (all when None):
        attention flops / bytes / bound seconds forward and backward, the
        CE forward's, and the model FLOPs."""
        D, H, hd, F = self.dim, self.heads, self.hd, self.ffn
        pf, pb = self.peak_flops, self.peak_bytes
        out = dict.fromkeys(("attn_fwd_bound_s", "attn_bwd_bound_s", "attn_fwd_flops",
                             "attn_bwd_flops", "ce_fwd_bound_s", "ce_fwd_flops",
                             "model_flops"), 0.0)
        block_lin = 2.0 * (4 * D * D + 3 * D * F)  # qkv, proj and the gated MLP, a row
        cache = {}
        for rec in self.records:
            if tags is not None and rec[0] not in tags:
                continue
            kind = rec[1]
            if kind == "enc":
                (B, N, _), mask, grad = rec[2], rec[3], rec[4]
                key = (id(mask), "enc")
                if key not in cache:
                    cache[key] = self._live_keys(mask, B, N)
                live = cache[key]
                calls = [(live, live * live, live)]
                lin = float(live.sum()) * block_lin
            elif kind == "dec":
                (B, M, _), (_, N, _), sa, xa, grad = rec[2], rec[3], rec[4], rec[5], rec[6]
                key = (id(sa), id(xa), "dec")
                if key not in cache:
                    rows, pairs = self._segments(sa, B, M)
                    cache[key] = (rows, pairs, self._live_keys(xa, B, N))
                rows, pairs, keys = cache[key]
                calls = [(rows, pairs, rows), (rows, rows * keys, keys)]
                lin = (float(rows.sum()) * (block_lin + 2.0 * 2 * D * D)
                       + float(keys.sum()) * 2.0 * 2 * D * D)
            else:
                mask, mods, grad = rec[2], rec[3], rec[4]
                key = (id(mask), "loss")
                if key not in cache:
                    cache[key] = {m: float((mask == self.mod_ids[m]).sum()) for m in mods}
                for m, rows in cache[key].items():
                    fl = 2.0 * rows * D * self.vocab[m]
                    nb = 2.0 * D * (rows + self.vocab[m]) + 8.0 * rows
                    out["ce_fwd_flops"] += fl
                    out["ce_fwd_bound_s"] += bound_s(fl, nb, pf, pb)
                    out["model_flops"] += fl * (3 if grad else 1)
                continue
            attn_fl = 0.0
            for rows, pairs, keys in calls:
                for b in range(len(rows)):
                    fl, nb = attention_cost(float(rows[b]), float(pairs[b]), float(keys[b]),
                                            H, hd, False)
                    out["attn_fwd_flops"] += fl
                    out["attn_fwd_bound_s"] += bound_s(fl, nb, pf, pb)
                    attn_fl += fl
                    if grad:
                        fl, nb = attention_cost(float(rows[b]), float(pairs[b]),
                                                float(keys[b]), H, hd, True)
                        out["attn_bwd_flops"] += fl
                        out["attn_bwd_bound_s"] += bound_s(fl, nb, pf, pb)
            out["model_flops"] += (lin + attn_fl) * (3 if grad else 1)
        return out


def train_flops_per_sample(n_in=2048, n_tgt=2048, n_layers=12, dim=768, h=2048, vocab=64000):
    """Model FLOPs of one training sample by the formula the port's training
    scripts use (bench_train.py:32-47, chip_smoke.py:train_flops_per_sample):
    forward products (encoder at n_in, decoder self at n_tgt and cross to
    n_in, the head at `vocab` for every target) times 3."""
    enc = n_layers * (8 * n_in * dim ** 2 + 4 * n_in ** 2 * dim + 6 * n_in * dim * h)
    dec = n_layers * (8 * n_tgt * dim ** 2 + 4 * n_tgt ** 2 * dim + 4 * n_tgt * n_in * dim
                      + 4 * n_tgt * dim ** 2 + 4 * n_in * dim ** 2 + 6 * n_tgt * dim * h)
    return 3 * (enc + dec + 2 * n_tgt * dim * vocab)
