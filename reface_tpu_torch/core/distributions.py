"""Latent distributions (PyTorch port of reface_tpu/core/distributions.py)."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["DiagonalGaussian", "normal_kl"]


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Diagonal Gaussian over VAE latents, parameterized by (mean, logvar).

    Built from the VAE encoder moments (B, 2C, H, W) split along `dim`;
    logvar is clamped to [-30, 20] like the reference.
    """

    mean: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_moments(moments: torch.Tensor, dim: int = 1) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments, 2, dim=dim)
        return DiagonalGaussian(mean, torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """KL(self || other), or against N(0, 1) when other is None, summed
        over every dimension but the batch: (B,)."""
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(self.mean**2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var
            - 1.0 - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """Negative log-likelihood of `sample`, summed over every dimension
        but the batch: (B,)."""
        logtwopi = math.log(2.0 * math.pi)
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(logtwopi + self.logvar + (sample - self.mean) ** 2 / self.var,
                               dim=dims)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians, elementwise."""
    exp = lambda a: torch.exp(torch.as_tensor(a))
    return 0.5 * (-1.0 + logvar2 - logvar1 + exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * exp(-logvar2))
