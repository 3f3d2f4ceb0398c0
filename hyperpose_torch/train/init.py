"""flax.linen's default initialization for the port's modules.

`flax_init_(model, generator)` draws every parameter as the flax module it
ports would be initialized by `Module.init`: conv and dense kernels
lecun-normal (a normal truncated at two standard deviations, scaled so the
kernel's standard deviation is sqrt(1 / fan_in), fan_in = kernel height x
width x input channels per group, or the inputs of a dense layer), biases 0,
BatchNorm scale 1 and bias 0 with running mean 0 and variance 1, PReLU
slopes 0 (the flax `PRelu`'s constant), and `SeparableConv`'s bare kernels
lecun-normal with its bias 0. It matches flax in distribution, not in bits:
the numbers come from `generator`, in the order of `model.modules()`.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]; flax divides
# by it so that the truncated draw has the variance asked for.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal()`: variance_scaling(1, "fan_in", "truncated_normal")."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _fan_in(w: torch.Tensor) -> int:
    """Inputs per output of a torch conv weight [out, in/groups, kh, kw] or
    dense weight [out, in]."""
    return int(math.prod(w.shape[1:]))


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and BatchNorm statistic of `model` in
    place as flax's defaults do (see the module docstring); returns it."""
    from ..models.backbones import VggTinyFusedStem
    from ..models.openpose import PRelu, SeparableConv

    for mod in model.modules():
        if isinstance(mod, VggTinyFusedStem):
            raise NotImplementedError(
                "VggTinyFusedStem is a serving-only transform: train VggTiny and "
                "remap_vggtiny_to_fused the checkpoint")
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            lecun_normal_(mod.weight, _fan_in(mod.weight), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.BatchNorm2d):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            mod.reset_running_stats()
        elif isinstance(mod, PRelu):
            nn.init.zeros_(mod.alpha)
        elif isinstance(mod, SeparableConv):
            lecun_normal_(mod.dw_kernel, _fan_in(mod.dw_kernel), generator)
            lecun_normal_(mod.pw_kernel, _fan_in(mod.pw_kernel), generator)
            nn.init.zeros_(mod.bias)
    return model


def flax_init_on_cpu_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """`flax_init_` drawn on a contiguous CPU copy of `model` and copied
    into it, so every device and memory layout starts from the same numbers
    (a generator fills a tensor in memory order, and the card's model is
    channels-last). Returns `model`."""
    shadow = copy.deepcopy(model).to("cpu").to(memory_format=torch.contiguous_format)
    shadow = flax_init_(shadow, generator).state_dict()
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(shadow[k])
    return model
