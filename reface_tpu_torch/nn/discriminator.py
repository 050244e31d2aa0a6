"""PatchGAN discriminator of the VAE trainer (port of
reface_tpu/nn/discriminator.py), NCHW.

taming-transformers' NLayerDiscriminator, which the reference's
LPIPSWithDiscriminator builds: 4x4 convs, a stride-2 pyramid to
min(2^n, 8) * ndf channels, BatchNorm and LeakyReLU(0.2), a stride-1 level,
then a 1-channel head; the convs under a norm have no bias. Modules sit
under taming's `main.<i>` names (convs at 0, 2, 5, 8 and 11, norms at 3, 6
and 9 for n_layers = 3), so a taming state dict's weights load as they are.

The norm is BatchNorm's training-mode arithmetic over the batch statistics
(biased variance, eps 1e-5, in fp32) with no running averages, as the JAX
package's _BatchStatNorm: the discriminator only ever runs in training.
`init_discriminator` is taming's weights_init: conv kernels N(0, 0.02),
conv biases 0, norm scale N(1, 0.02), norm bias 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.layers import Conv2d

__all__ = ["BatchStatNorm", "NLayerDiscriminator", "init_discriminator"]


class BatchStatNorm(nn.Module):
    """BatchNorm2d's training-mode arithmetic without running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.reshape(1, -1, 1, 1)
                + self.bias.reshape(1, -1, 1, 1)).to(x.dtype)


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2)


class NLayerDiscriminator(nn.Module):
    """(B, C, H, W) image -> (B, 1, h, w) fp32 patch logits."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        layers = [Conv2d(input_nc, ndf, 4, stride=2, padding=1, **kw), _LeakyReLU()]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * mult, 4, stride=2 if n < n_layers else 1,
                              padding=1, bias=False, **kw),
                       BatchStatNorm(ndf * mult, device=device), _LeakyReLU()]
        layers.append(Conv2d(ndf * mult, 1, 4, stride=1, padding=1, **kw))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x).float()


@torch.no_grad()
def init_discriminator(disc: NLayerDiscriminator, seed: int = 0) -> NLayerDiscriminator:
    """taming's weights_init from a seed, on the module's device."""
    gen = torch.Generator(device=next(disc.parameters()).device).manual_seed(seed)
    for m in disc.modules():
        if isinstance(m, Conv2d):
            m.weight.normal_(0.0, 0.02, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchStatNorm):
            m.weight.normal_(1.0, 0.02, generator=gen)
            m.bias.zero_()
    return disc
