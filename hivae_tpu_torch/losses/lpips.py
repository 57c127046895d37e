"""LPIPS perceptual distance (port of ``hivae_tpu/losses/lpips.py``): the
LPIPS input scaling, VGG16 features tapped after relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3, unit-normalised over channels, squared differences
weighted by learned 1x1 heads, averaged over space and summed over the five
taps. NCHW throughout; the VGG16 layers keep torchvision's
``features.<index>`` names and the heads are ``lin0``..``lin4``
(``utils/params.lpips_flax_to_torch`` maps the JAX tree onto them;
``lpips_state`` maps torchvision's VGG16 and the LPIPS ``vgg.pth`` heads).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
from torch import nn

# torchvision VGG16 conv widths, 'M' = 2x2 max pool
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
# Sequential indices of the relus whose outputs are tapped
_TAPS = (3, 8, 15, 22, 29)
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


class VGG16Features(nn.Module):
    """VGG16 ``features`` up to relu5_3 -> the five tapped maps (NCHW)."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for spec in _VGG16:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, spec, 3, padding=1),
                           nn.ReLU()]
                c_in = spec
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAPS:
                outs.append(x)
        return outs


class LPIPS(nn.Module):
    """Perceptual distance between NCHW images in [-1, 1] -> (N, 1, 1, 1)."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, c in enumerate((64, 128, 256, 512, 512)):
            setattr(self, f"lin{k}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dtype = self.lin0.weight.dtype
        fx = self.net(((x - self.shift) / self.scale).to(dtype))
        fy = self.net(((y - self.shift) / self.scale).to(dtype))
        val = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            diff = torch.square(_unit_norm(a) - _unit_norm(b))
            head = getattr(self, f"lin{k}")
            val = val + head(diff).mean(dim=(2, 3), keepdim=True)
        return val


def _unit_norm(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(torch.square(f), dim=1, keepdim=True))
                + eps)


def lpips_state(vgg: Dict[str, torch.Tensor],
                head: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The ``LPIPS`` state dict from a torchvision VGG16 state dict
    (``features.<i>.*``, under ``net.``) and, optionally, the LPIPS
    ``vgg.pth`` heads (``lin<k>.model.1.weight``, as ``lin<k>.weight``).
    Keys of neither kind (the VGG classifier) are passed on, unused."""
    state = {f"net.{k}": v for k, v in vgg.items()}
    for k, v in (head or {}).items():
        state[re.sub(r"^lin(\d)\.model\.1\.", r"lin\1.", k)] = v
    return state
