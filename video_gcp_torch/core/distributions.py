"""Diagonal Gaussian latents (blox.torch.variational surface) and the
categorical helpers of the train path (core/distributions.py of the JAX
package). Every random draw takes an explicit `torch.Generator`: normal draws
go through `Gaussian.sample`, uniform draws through `uniform`."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class Gaussian:
    mu: torch.Tensor
    log_sigma: torch.Tensor

    @classmethod
    def from_concat(cls, x: torch.Tensor) -> "Gaussian":
        """Last axis is [mu; log_sigma]; log_sigma is clipped to +-10."""
        mu, log_sigma = torch.chunk(x, 2, dim=-1)
        return cls(mu=mu, log_sigma=torch.clamp(log_sigma, -10.0, 10.0))

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma)

    def reparametrize(self, eps: torch.Tensor) -> torch.Tensor:
        """Map a standard-normal sample into this Gaussian (injected planner
        latents, tree_module.py:81-82)."""
        return self.mu + self.sigma * eps

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        if generator is None:
            raise ValueError("Gaussian.sample needs an explicit torch.Generator")
        eps = torch.randn(self.mu.shape, generator=generator,
                          device=self.mu.device, dtype=self.mu.dtype)
        return self.reparametrize(eps)

    def kl_divergence(self, other: "Gaussian") -> torch.Tensor:
        """KL(self || other) per dimension (no reduction)."""
        return (other.log_sigma - self.log_sigma
                + (self.sigma ** 2 + (self.mu - other.mu) ** 2)
                / (2.0 * other.sigma ** 2) - 0.5)

    def entropy(self) -> torch.Tensor:
        return 0.5 + 0.5 * math.log(2 * math.pi) + self.log_sigma

    def nll(self, x: torch.Tensor) -> torch.Tensor:
        return (0.5 * ((x - self.mu) / self.sigma) ** 2 + self.log_sigma
                + 0.5 * math.log(2 * math.pi))

    @staticmethod
    def cat(parts, dim: int) -> "Gaussian":
        return Gaussian(mu=torch.cat([p.mu for p in parts], dim),
                        log_sigma=torch.cat([p.log_sigma for p in parts], dim))


def unit_gaussian(shape, device=None, dtype=torch.float32) -> Gaussian:
    """Fixed standard-normal prior (blox FixedPrior)."""
    zeros = torch.zeros(shape, device=device, dtype=dtype)
    return Gaussian(mu=zeros, log_sigma=zeros.clone())


def uniform(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """float32 draws from U[0, 1); every uniform draw of the train path."""
    if generator is None:
        raise ValueError("uniform needs an explicit torch.Generator")
    return torch.rand(shape, generator=generator, device=device)


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """A nonnegative tensor scaled to sum to 1 along `dim`
    (blox.torch.dist.normalize; adaptive.py:58)."""
    return x / (x.sum(dim=dim, keepdim=True) + eps)


def safe_entropy(dist: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Entropy of categorical distributions given as probabilities
    (blox.torch.dist.safe_entropy; match distributions, tree_module.py:145)."""
    return -torch.sum(dist * torch.log(dist + eps), dim=dim)
