"""Mega-NeRF's per-cluster model as plain ``torch.nn`` modules: the
``Embedding``, ``ShiftedSoftplus`` and ``NeRF`` of Turki et al.,
"Mega-NeRF" (CVPR 2022, arXiv:2112.10703), ``mega_nerf/models/nerf.py``,
transcribed.  It imports neither JAX nor either package of this
repository; the tests hold the port's converted model against it, and
script it into the containers that ``MegaNeRFModel.from_torchscript``
loads.

Departures from ``nerf.py``:
  * ``forward`` takes no ``sigma_noise`` (a training-time perturbation of
    sigma, never passed by the viewer's ``sub_module(x, False)`` call);
  * ``skip_first`` (default True, ``nerf.py``'s order) puts the encoded
    input after the hidden state when False: a wrong order that the tests
    build to see the port's converter refuse it.

Parameter names are ``nerf.py``'s (``xyz_encodings.<i>.0``, ``sigma``,
``xyz_encoding_final``, ``embedding_a``, ``dir_a_encoding.0``, ``rgb``,
``affine``), which the port's converter recognises.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn


class Embedding(nn.Module):
    """``[x, sin(f_0 x), cos(f_0 x), ..., sin(f_{F-1} x), cos(f_{F-1}
    x)]`` with ``f = 2 ** linspace(0, F - 1, F)`` (``logscale``), else
    ``linspace(1, 2 ** (F - 1), F)``."""

    def __init__(self, num_freqs: int, logscale: bool = True):
        super().__init__()
        if logscale:
            self.freq_bands = 2 ** torch.linspace(0, num_freqs - 1,
                                                  num_freqs)
        else:
            self.freq_bands = torch.linspace(1, 2 ** (num_freqs - 1),
                                             num_freqs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = [x]
        for freq in self.freq_bands:
            out += [torch.sin(freq * x), torch.cos(freq * x)]
        return torch.cat(out, -1)


class ShiftedSoftplus(nn.Module):
    """``softplus(x - 1)``, Mega-NeRF's ``--sigma_activation softplus``."""
    __constants__ = ["beta", "threshold"]
    beta: int
    threshold: int

    def __init__(self, beta: int = 1, threshold: int = 20):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softplus(x - 1, self.beta, self.threshold)


class NeRF(nn.Module):
    def __init__(self, pos_xyz_dim: int, pos_dir_dim: int, layers: int,
                 skip_layers: List[int], layer_dim: int,
                 appearance_dim: int, affine_appearance: bool,
                 appearance_count: int, rgb_dim: int, xyz_dim: int,
                 sigma_activation: nn.Module, skip_first: bool = True):
        super().__init__()
        self.xyz_dim = xyz_dim
        if rgb_dim > 3:
            assert pos_dir_dim == 0
        self.embedding_xyz = Embedding(pos_xyz_dim)
        in_channels_xyz = xyz_dim + xyz_dim * pos_xyz_dim * 2
        self.skip_layers = skip_layers
        self.skip_first = skip_first

        xyz_encodings = []
        for i in range(layers):
            if i == 0:
                layer = nn.Linear(in_channels_xyz, layer_dim)
            elif i in skip_layers:
                layer = nn.Linear(layer_dim + in_channels_xyz, layer_dim)
            else:
                layer = nn.Linear(layer_dim, layer_dim)
            xyz_encodings.append(nn.Sequential(layer, nn.ReLU(True)))
        self.xyz_encodings = nn.ModuleList(xyz_encodings)

        if pos_dir_dim > 0:
            self.embedding_dir = Embedding(pos_dir_dim)
            in_channels_dir = 3 + 3 * pos_dir_dim * 2
        else:
            self.embedding_dir = None
            in_channels_dir = 0

        if appearance_dim > 0:
            self.embedding_a = nn.Embedding(appearance_count, appearance_dim)
        else:
            self.embedding_a = None

        if pos_dir_dim > 0 or (appearance_dim > 0 and not affine_appearance):
            self.xyz_encoding_final = nn.Linear(layer_dim, layer_dim)
            self.dir_a_encoding = nn.Sequential(
                nn.Linear(layer_dim + in_channels_dir
                          + (appearance_dim if not affine_appearance else 0),
                          layer_dim // 2),
                nn.ReLU(True))
        else:
            self.xyz_encoding_final = None
            self.dir_a_encoding = None

        self.sigma = nn.Linear(layer_dim, 1)
        self.sigma_activation = sigma_activation
        self.rgb = nn.Linear(
            layer_dim // 2 if (pos_dir_dim > 0 or (
                appearance_dim > 0 and not affine_appearance))
            else layer_dim, rgb_dim)
        # SH coefficients (rgb_dim > 3) leave the sigmoid to the renderer
        self.rgb_activation = nn.Sigmoid() if rgb_dim == 3 else None

        if affine_appearance:
            assert appearance_dim > 0
            self.affine = nn.Linear(appearance_dim, 12)
        else:
            self.affine = None

    def forward(self, x: torch.Tensor,
                sigma_only: bool = False) -> torch.Tensor:
        expected = self.xyz_dim \
            + (0 if (sigma_only or self.embedding_dir is None) else 3) \
            + (0 if (sigma_only or self.embedding_a is None) else 1)
        if x.shape[1] != expected:
            raise Exception("Unexpected input shape: {} (expected: {}, "
                            "xyz_dim: {})".format(x.shape, expected,
                                                  self.xyz_dim))

        input_xyz = self.embedding_xyz(x[:, :self.xyz_dim])
        xyz_ = input_xyz
        for i, xyz_encoding in enumerate(self.xyz_encodings):
            if i in self.skip_layers:
                if self.skip_first:
                    xyz_ = torch.cat([input_xyz, xyz_], -1)
                else:
                    xyz_ = torch.cat([xyz_, input_xyz], -1)
            xyz_ = xyz_encoding(xyz_)

        sigma = self.sigma_activation(self.sigma(xyz_))
        if sigma_only:
            return sigma

        final = self.xyz_encoding_final
        dir_a = self.dir_a_encoding
        if final is None or dir_a is None:
            rgb = self.rgb(xyz_)
        else:
            dir_a_encoding_input = [final(xyz_)]
            embedding_dir = self.embedding_dir
            if embedding_dir is not None:
                dir_a_encoding_input.append(embedding_dir(x[:, -4:-1]))
            embedding_a = self.embedding_a
            if embedding_a is not None and self.affine is None:
                dir_a_encoding_input.append(embedding_a(x[:, -1].long()))
            rgb = self.rgb(dir_a(torch.cat(dir_a_encoding_input, -1)))

        affine = self.affine
        embedding_a = self.embedding_a
        if affine is not None and embedding_a is not None:
            t = affine(embedding_a(x[:, -1].long())).view(-1, 3, 4)
            rgb = (t[:, :, :3] @ rgb.unsqueeze(-1)
                   + t[:, :, 3:]).squeeze(-1)

        act = self.rgb_activation
        return torch.cat([act(rgb) if act is not None else rgb, sigma], -1)


def mill19(appearance_count: int, basis_dim: int = 4,
           layer_dim: int = 256, pos_xyz_dim: int = 12, layers: int = 8,
           skip_layers=(4,), appearance_dim: int = 48,
           sigma_activation: str = "relu", skip_first: bool = True) -> NeRF:
    """The submodule at Mega-NeRF's Mill 19 options (``pos_xyz_dim`` 12,
    8 layers of 256, a skip at 4, ``appearance_dim`` 48, no direction
    encoding, an SH head of ``3 * basis_dim``); smaller widths for the
    tests' chunked route."""
    act = nn.ReLU() if sigma_activation == "relu" else ShiftedSoftplus()
    return NeRF(pos_xyz_dim, 0, layers, list(skip_layers), layer_dim,
                appearance_dim, False, appearance_count, 3 * basis_dim, 3,
                act, skip_first)
