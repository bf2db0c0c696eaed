"""Frozen ViT feature teachers of the feature-map VQ-VAE trainer.

Port of egom2p_tpu/models/teachers.py (reference:
run_training_vqvae.py:460-481 `get_feature_extractor`, 949-1002): a frozen
CLIP / DINOv2 / ImageBind vision transformer embeds rgb images and the
feature VQ-VAE (tokenizers/feature_vqvae.py) learns to compress its
patch-token grid.  Each spec mirrors the published tower:

  * CLIP visual (egom2p/utils/clip/model.py:228-285,
    `return_final_tokens_no_cls`): a bias-free patchify, the class
    embedding, a learned posemb, ln_pre, pre-LN blocks with QuickGELU MLPs,
    ln_post over every token, then `proj`; the map is the projected patch
    tokens;
  * DINOv2 (torch.hub dinov2_vitb14 / vitg14): a patchify with bias, the cls
    token, a learned posemb, blocks with LayerScale, an MLP (B14) or a fused
    SwiGLU (G14), the final norm; `-global` emits the normed cls token as a
    1 x 1 map;
  * ImageBind-H14: the ViT-H/14 vision trunk (width 1280) with ln_pre, read
    before any final norm or head (num_channels 1280).

Inputs are channel-last (B, H, W, 3) in [-1, 1]; an input of another size
is first resized bilinearly to the spec's, antialiased when it shrinks, as
jax.image.resize does; each spec then renormalizes to its teacher's
statistics.  Attention goes through models/transformer.py's routing: 257
tokens of heads of 64 (DINOv2-B14 / G14, CLIP-L14) take the flash64_train
forward kernel, ImageBind's heads of 80 the stock route's width-80 forward,
CLIP-B16's 197 tokens the dense path.

Weights: `teacher_state_dict_from_torch` reads the published torch layouts
(OpenAI CLIP, torch.hub DINOv2, ImageBind; egom2p_tpu/compat/
torch_convert.py:convert_teacher_state_dict's key rules) into this
module's state dict, interpolating a pretrain-grid posemb with the JAX
converter's numpy / scipy bicubic (`interp_posemb`), and `load_teacher_pth`
reads such a file; compat/from_jax.py carries the JAX package's weights.
Without a checkpoint a tower takes random weights from a generator (smoke
runs only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.core.image_ops import resize_bilinear
from egom2p_torch.models.transformer import Attention, GatedMlp, LayerNorm, Mlp, gelu

# Pretraining normalization statistics (image in [0, 1]).
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class TeacherSpec:
    name: str
    patch: int
    width: int
    depth: int
    heads: int
    feat_dim: int          # channels of the emitted feature map
    mlp: str = "gelu"      # "quick_gelu" | "gelu" | "swiglu"
    ln_pre: bool = False
    ln_post: bool = True
    layerscale: bool = False
    patch_bias: bool = True
    proj: bool = False     # CLIP: project tokens by the `proj` matrix
    global_pool: bool = False  # emit the cls token as a (1, 1) map
    image_size: int = 224
    ln_eps: float = 1e-6
    mean: Tuple[float, float, float] = _IMAGENET_MEAN
    std: Tuple[float, float, float] = _IMAGENET_STD

    @property
    def grid(self) -> int:
        return self.image_size // self.patch


def _clip(name, patch, width, depth, heads, feat_dim):
    return TeacherSpec(name=name, patch=patch, width=width, depth=depth, heads=heads,
                       feat_dim=feat_dim, mlp="quick_gelu", ln_pre=True, patch_bias=False,
                       proj=True, ln_eps=1e-5, mean=_CLIP_MEAN, std=_CLIP_STD)


def _dino(name, width, depth, heads, mlp, global_pool):
    return TeacherSpec(name=name, patch=14, width=width, depth=depth, heads=heads,
                       feat_dim=width, mlp=mlp, layerscale=True, global_pool=global_pool)


def _imagebind(name, global_pool):
    return TeacherSpec(name=name, patch=14, width=1280, depth=32, heads=16, feat_dim=1280,
                       ln_pre=True, ln_post=False, patch_bias=False, global_pool=global_pool,
                       mean=_CLIP_MEAN, std=_CLIP_STD)


# keyed by the reference's --domain names (FEAT_MODALITIES, run_training_vqvae.py:78)
TEACHER_SPECS = {
    "CLIP-B16": _clip("CLIP-B16", 16, 768, 12, 12, 512),
    "CLIP-L14": _clip("CLIP-L14", 14, 1024, 24, 16, 768),
    "DINOv2-B14": _dino("DINOv2-B14", 768, 12, 12, "gelu", False),
    "DINOv2-B14-global": _dino("DINOv2-B14-global", 768, 12, 12, "gelu", True),
    "DINOv2-G14": _dino("DINOv2-G14", 1536, 40, 24, "swiglu", False),
    "DINOv2-G14-global": _dino("DINOv2-G14-global", 1536, 40, 24, "swiglu", True),
    "ImageBind-H14": _imagebind("ImageBind-H14", False),
    "ImageBind-H14-global": _imagebind("ImageBind-H14-global", True),
}


class PatchEmbed(nn.Conv2d):
    """kernel = stride = p Conv2d on channel-last images, as a product:
    (B, H, W, C) -> (B, H/p, W/p, dim)."""

    def __init__(self, in_channels: int, dim: int, p: int, bias: bool):
        super().__init__(in_channels, dim, kernel_size=p, stride=p, bias=bias)

    def forward(self, x):
        B, H, W, C = x.shape
        p = self.kernel_size[0]
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        weight = self.weight.permute(0, 2, 3, 1).reshape(self.out_channels, -1).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x.reshape(B, H // p, W // p, p * p * C), weight, bias)


class TeacherBlock(nn.Module):
    """Pre-LN ViT block with optional LayerScale (DINOv2) and a QuickGELU /
    GELU / fused-SwiGLU MLP."""

    def __init__(self, dim: int, num_heads: int, mlp: str, layerscale: bool, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=eps)
        if mlp == "swiglu":
            # GatedMlp's 2/3 reproduces DINOv2's SwiGLUFFNFused hidden size
            self.mlp = GatedMlp(dim, dim * 4, act=F.silu)
        else:
            self.mlp = Mlp(dim, dim * 4, act=quick_gelu if mlp == "quick_gelu" else gelu)
        if layerscale:
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x):
        h = self.attn(self.norm1(x))
        x = x + (h if self.ls1 is None else h * self.ls1.to(h.dtype))
        h = self.mlp(self.norm2(x))
        return x + (h if self.ls2 is None else h * self.ls2.to(h.dtype))


class ViTTeacher(nn.Module):
    """Frozen feature tower: (B, H, W, 3) in [-1, 1] -> feature map
    (B, grid, grid, feat_dim), or (B, 1, 1, feat_dim) for -global; it
    computes in the dtype of its parameters."""

    def __init__(self, spec: TeacherSpec):
        super().__init__()
        s = self.spec = spec
        self.patch_embed = PatchEmbed(3, s.width, s.patch, s.patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, s.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + s.grid ** 2, s.width))
        self.ln_pre = LayerNorm(s.width, eps=s.ln_eps) if s.ln_pre else None
        self.blocks = nn.ModuleList(TeacherBlock(s.width, s.heads, s.mlp, s.layerscale, s.ln_eps)
                                    for _ in range(s.depth))
        self.ln_post = LayerNorm(s.width, eps=s.ln_eps) if s.ln_post else None
        self.proj = nn.Parameter(torch.zeros(s.width, s.feat_dim)) if s.proj else None
        self.register_buffer("mean", torch.tensor(s.mean), persistent=False)
        self.register_buffer("std", torch.tensor(s.std), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.cls_token.dtype

    def forward(self, x):
        s = self.spec
        x = x.to(self.dtype)
        if x.shape[1] != s.image_size or x.shape[2] != s.image_size:
            x = resize_bilinear(x, s.image_size)
        x = (x * 0.5 + 0.5 - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        x = self.patch_embed(x)
        B, nh, nw, _ = x.shape
        x = torch.cat([self.cls_token.expand(B, 1, -1), x.reshape(B, nh * nw, -1)], dim=1)
        x = x + self.pos_embed
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        if self.ln_post is not None:
            x = self.ln_post(x)
        if self.proj is not None:
            x = x @ self.proj
        if s.global_pool:
            return x[:, 0].reshape(B, 1, 1, s.feat_dim)
        return x[:, 1:].reshape(B, nh, nw, s.feat_dim)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "ViTTeacher":
        """flax's initializers (egom2p_tpu/models/teachers.py): lecun-normal
        weights, zero biases, unit norms, N(0, width^-1/2) cls token and
        proj, N(0, 0.02) posemb, LayerScale 1e-5."""
        w = self.spec.width
        for name, p in self.named_parameters():
            if name in ("cls_token", "proj"):
                p.normal_(0.0, w ** -0.5, generator=generator)
            elif name == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif name.endswith(("ls1", "ls2")):
                p.fill_(1e-5)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        return self


# ------------------------------------------------------ published weights
def interp_posemb(arr: np.ndarray, n_target: int) -> np.ndarray:
    """(1, 1+g0^2, w) learned posemb -> (1, 1+g1^2, w): the cls slot kept,
    the square patch grid resized bicubically with scipy, as
    egom2p_tpu/compat/torch_convert.py:_interp_posemb does (its output is
    bitwise the JAX converter's)."""
    from scipy.ndimage import zoom

    cls_tok, grid = arr[:, :1], arr[0, 1:]
    g0 = int(round(float(np.sqrt(grid.shape[0]))))
    g1 = int(round(float(np.sqrt(n_target - 1))))
    if g0 * g0 != grid.shape[0] or g1 * g1 != n_target - 1:
        raise ValueError(f"cannot interpolate posemb {arr.shape} -> {n_target} positions "
                         "(non-square grid)")
    grid = zoom(grid.reshape(g0, g0, -1), (g1 / g0, g1 / g0, 1.0), order=3, grid_mode=True,
                mode="nearest")
    return np.concatenate([cls_tok, grid.reshape(1, g1 * g1, -1)], axis=1)


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(x.detach().cpu().float().numpy() if hasattr(x, "detach")
                                else np.asarray(x, dtype=np.float32))


def teacher_state_dict_from_torch(sd: Dict, domain: str, spec: Optional[TeacherSpec] = None
                                  ) -> Dict[str, torch.Tensor]:
    """A published teacher state dict -> ViTTeacher's, for `domain`'s
    family (its spec from TEACHER_SPECS unless given): OpenAI CLIP visual
    towers (`visual.` prefix or bare, fused `in_proj` attention), torch.hub
    DINOv2 (LayerScale `gamma`, plain or fused-SwiGLU MLPs) and ImageBind's
    vision trunk (its 2-frame Conv3d stem summed over time to a 2-D conv:
    PadIm2Video feeds the same image to both taps).  A posemb at another
    grid is interpolated (interp_posemb)."""
    spec = spec or TEACHER_SPECS[domain]
    sd = {k: v for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}
    if domain.startswith("CLIP"):
        if any(k.startswith("visual.") for k in sd):
            sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
        out["patch_embed.weight"] = _np(sd["conv1.weight"])
        out["cls_token"] = _np(sd["class_embedding"]).reshape(1, 1, -1)
        out["pos_embed"] = _np(sd["positional_embedding"])[None]
        for n in ("ln_pre", "ln_post"):
            out[f"{n}.weight"], out[f"{n}.bias"] = _np(sd[f"{n}.weight"]), _np(sd[f"{n}.bias"])
        out["proj"] = _np(sd["proj"])
        for i in range(spec.depth):
            tb, pb = f"transformer.resblocks.{i}.", f"blocks.{i}."
            for a, b in (("ln_1", "norm1"), ("ln_2", "norm2"), ("attn.in_proj", "attn.qkv"),
                         ("attn.out_proj", "attn.proj"), ("mlp.c_fc", "mlp.fc1"),
                         ("mlp.c_proj", "mlp.fc2")):
                w = tb + (f"{a}_weight" if a == "attn.in_proj" else f"{a}.weight")
                bias = tb + (f"{a}_bias" if a == "attn.in_proj" else f"{a}.bias")
                out[pb + f"{b}.weight"], out[pb + f"{b}.bias"] = _np(sd[w]), _np(sd[bias])
    elif domain.startswith("DINOv2"):
        out["patch_embed.weight"] = _np(sd["patch_embed.proj.weight"])
        out["patch_embed.bias"] = _np(sd["patch_embed.proj.bias"])
        out["cls_token"], out["pos_embed"] = _np(sd["cls_token"]), _np(sd["pos_embed"])
        out["ln_post.weight"], out["ln_post.bias"] = _np(sd["norm.weight"]), _np(sd["norm.bias"])
        for i in range(spec.depth):
            tb = pb = f"blocks.{i}."
            for n in ("norm1", "norm2", "attn.qkv", "attn.proj"):
                out[pb + f"{n}.weight"] = _np(sd[tb + f"{n}.weight"])
                out[pb + f"{n}.bias"] = _np(sd[tb + f"{n}.bias"])
            out[pb + "ls1"], out[pb + "ls2"] = _np(sd[tb + "ls1.gamma"]), _np(sd[tb + "ls2.gamma"])
            if tb + "mlp.fc1.weight" in sd:  # plain MLP (B14)
                for n in ("fc1", "fc2"):
                    out[pb + f"mlp.{n}.weight"] = _np(sd[tb + f"mlp.{n}.weight"])
                    out[pb + f"mlp.{n}.bias"] = _np(sd[tb + f"mlp.{n}.bias"])
            else:  # fused SwiGLU (G14): w12's rows are [gate; value], w3 the output
                w12, b12 = _np(sd[tb + "mlp.w12.weight"]), _np(sd[tb + "mlp.w12.bias"])
                h = w12.shape[0] // 2
                out[pb + "mlp.fc1.weight"], out[pb + "mlp.fc1.bias"] = w12[:h], b12[:h]
                out[pb + "mlp.fc3.weight"], out[pb + "mlp.fc3.bias"] = w12[h:], b12[h:]
                out[pb + "mlp.fc2.weight"] = _np(sd[tb + "mlp.w3.weight"])
                out[pb + "mlp.fc2.bias"] = _np(sd[tb + "mlp.w3.bias"])
    elif domain.startswith("ImageBind"):
        pv, tv = "modality_preprocessors.vision.", "modality_trunks.vision."
        out["patch_embed.weight"] = _np(sd[pv + "rgbt_stem.proj.1.weight"]).sum(axis=2)
        out["cls_token"] = _np(sd[pv + "cls_token"]).reshape(1, 1, -1)
        out["pos_embed"] = _np(sd[pv + "pos_embedding_helper.pos_embed"])
        out["ln_pre.weight"] = _np(sd[tv + "pre_transformer_layer.0.weight"])
        out["ln_pre.bias"] = _np(sd[tv + "pre_transformer_layer.0.bias"])
        for i in range(spec.depth):
            tb, pb = f"{tv}blocks.{i}.", f"blocks.{i}."
            for a, b in (("norm_1", "norm1"), ("norm_2", "norm2"), ("attn.out_proj", "attn.proj"),
                         ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                out[pb + f"{b}.weight"] = _np(sd[tb + f"{a}.weight"])
                out[pb + f"{b}.bias"] = _np(sd[tb + f"{a}.bias"])
            out[pb + "attn.qkv.weight"] = _np(sd[tb + "attn.in_proj_weight"])
            out[pb + "attn.qkv.bias"] = _np(sd[tb + "attn.in_proj_bias"])
    else:
        raise ValueError(f"unknown teacher domain {domain!r}")
    n_pos = 1 + spec.grid ** 2
    if out["pos_embed"].shape[1] != n_pos:
        # checkpoints keep pos_embed at the pretrain grid (DINOv2's hub
        # weights: img_size 518, 1 + 37^2 positions)
        out["pos_embed"] = interp_posemb(out["pos_embed"], n_pos)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _read_torch_file(path: str) -> Dict:
    """A teacher checkpoint's state dict: a TorchScript archive, or a .pth
    nested under 'state_dict' / 'model' or flat (the JAX loader's reading,
    egom2p_tpu/compat/torch_convert.py:load_teacher_pth), read with
    weights_only=True: a file that pickles code raises."""
    if path.endswith((".jit", ".pt")):
        try:
            return dict(torch.jit.load(path, map_location="cpu").state_dict())
        except RuntimeError:
            pass
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt)) if isinstance(ckpt, dict) else ckpt
    return dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)


def load_teacher_pth(path: str, domain: str, spec: Optional[TeacherSpec] = None,
                     device="cuda") -> ViTTeacher:
    """A published teacher checkpoint on disk -> a ViTTeacher on `device`,
    the card by default (every key of the tower checked)."""
    from egom2p_torch.core.checkpoint import copy_state_dict
    from egom2p_torch.core.device import resolve_device

    device = resolve_device(device)
    teacher = ViTTeacher(spec or TEACHER_SPECS[domain])
    sd = teacher_state_dict_from_torch(_read_torch_file(path), domain, teacher.spec)
    copy_state_dict(teacher, sd, f"{domain} teacher weights {path}")
    return teacher.to(device)


def get_feature_extractor(domain: str, ckpt_path: Optional[str] = None,
                          generator: Optional[torch.Generator] = None, device="cuda"):
    """The frozen teacher of a feature domain on `device` (the card by
    default), in eval mode with no gradients (reference
    run_training_vqvae.py:460-481; weights from a local checkpoint, else
    random from `generator`): (teacher, spec), or None for a domain that is
    not a feature domain."""
    from egom2p_torch.core.device import resolve_device

    if domain not in TEACHER_SPECS:
        return None
    device = resolve_device(device)
    spec = TEACHER_SPECS[domain]
    if ckpt_path:
        teacher = load_teacher_pth(ckpt_path, domain, device=device)
    else:
        teacher = ViTTeacher(spec).to(device)
        teacher.init_random_(generator or torch.Generator(device).manual_seed(0))
    return teacher.eval().requires_grad_(False), spec
