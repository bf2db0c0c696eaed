"""Latent distributions of the continuous (CI / CV) tokenizers.

Port of egom2p_tpu/tokenizers/cosmos/distributions.py (reference:
cosmos_tokenizer/modules/distributions.py:20-41).  Channel-last: the
Gaussian's parameters are split along the last axis.  The VAE's sample
takes its standard normal draws as `noise`, or from a torch.Generator.
"""
from __future__ import annotations

from typing import Optional

import torch


def identity_distribution(parameters: torch.Tensor):
    """The AE formulation: the latent is the encoder's output as it is."""
    zero = torch.zeros((1,), dtype=parameters.dtype, device=parameters.device)
    return parameters, (zero, zero)


def gaussian_distribution(parameters: torch.Tensor, generator: Optional[torch.Generator] = None,
                          min_logvar: float = -30.0, max_logvar: float = 20.0,
                          noise: Optional[torch.Tensor] = None):
    """The VAE formulation: a sample of N(mean, exp(logvar)) by the
    reparameterization trick, with `noise` or draws from `generator`; with
    neither, the mean (the deterministic eval)."""
    mean, logvar = parameters.chunk(2, dim=-1)
    logvar = logvar.clamp(min_logvar, max_logvar)
    if noise is None and generator is None:
        return mean, (mean, logvar)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    std = torch.exp(0.5 * logvar)
    return mean + std * noise.to(mean), (mean, logvar)
