"""DBPN, the deep back-projection network (counterpart of
``rdst_tpu/models/dbpn.py``).

Alternating up- and down-projection units; with ``dense`` (D-DBPN) each
unit takes every earlier unit's output of its kind side by side, merged
by a 1x1 conv (``input``) from the second unit of a kind on (the first
dense input is a single map, and the reference makes no merge conv for
it). The reconstruction conv reads every up-projection's output. The
deconvolutions are torch's ``ConvTranspose2d(k, s, p)``, which is the
JAX package's ``ConvTranspose(k, s, 'VALID')`` cropped by p on each side;
(k, s, p) by scale: x2 (6, 2, 2), x4 (8, 4, 2), x8 (12, 8, 2). 'prelu' is
a fixed 0.25 slope; no mean shift.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import Conv, ConvTranspose

CONV_PARAS = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def _prelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.25)


class Deconv(nn.Module):
    """flax ``_Deconv``: the transposed conv under the name ``deconv``."""

    def __init__(self, in_c: int, out_c: int, k: int, s: int, p: int):
        super().__init__()
        self.deconv = ConvTranspose(in_c, out_c, k, s, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


class UpProjectionUnit(nn.Module):
    def __init__(self, in_c: int, out_c: int, sr_factor: int,
                 dense_input: bool = False):
        super().__init__()
        k, s, p = CONV_PARAS[sr_factor]
        self.dense_input = bool(dense_input)
        if self.dense_input:
            self.input = Conv(in_c, out_c, 1)
        self.deconv_0 = Deconv(out_c, out_c, k, s, p)
        self.conv = Conv(out_c, out_c, k, stride=s, padding=p)
        self.deconv_1 = Deconv(out_c, out_c, k, s, p)

    def forward(self, lt_1: torch.Tensor) -> torch.Tensor:
        if self.dense_input:
            lt_1 = _prelu(self.input(lt_1))
        ht0 = _prelu(self.deconv_0(lt_1))
        lt0 = _prelu(self.conv(ht0))
        return ht0 + _prelu(self.deconv_1(lt0 - lt_1))


class DownProjectionUnit(nn.Module):
    def __init__(self, in_c: int, out_c: int, sr_factor: int,
                 dense_input: bool = False):
        super().__init__()
        k, s, p = CONV_PARAS[sr_factor]
        self.dense_input = bool(dense_input)
        if self.dense_input:
            self.input = Conv(in_c, out_c, 1)
        self.conv_0 = Conv(out_c, out_c, k, stride=s, padding=p)
        self.deconv = Deconv(out_c, out_c, k, s, p)
        self.conv_1 = Conv(out_c, out_c, k, stride=s, padding=p)

    def forward(self, ht: torch.Tensor) -> torch.Tensor:
        if self.dense_input:
            ht = _prelu(self.input(ht))
        lt0 = _prelu(self.conv_0(ht))
        ht0 = _prelu(self.deconv(lt0))
        return lt0 + _prelu(self.conv_1(ht0 - ht))


class DBPN(NoKernels, nn.Module):
    """``forward(x, sr_scale=None)`` on NHWC tensors; the scale is not
    read (the unit geometry is the model's ``sr_scale``)."""

    def __init__(self, in_chans: int = 1, n0: int = 256, nr: int = 64,
                 t: int = 7, sr_scale: int = 4, dense: bool = True,
                 dtype: torch.dtype = torch.float32, train_resolution=None):
        super().__init__()
        if int(sr_scale) not in CONV_PARAS:
            raise ValueError(f"DBPN scale {sr_scale}: one of "
                             f"{sorted(CONV_PARAS)}")
        self._no_kernels(dtype, train_resolution)
        self.t, self.dense = int(t), bool(dense)
        self.input_conv_0 = Conv(in_chans, n0, 3)
        self.input_conv_1 = Conv(n0, nr, 1)
        for i in range(self.t):
            self.add_module(f"up_{i}", UpProjectionUnit(
                i * nr, nr, int(sr_scale), dense_input=self.dense and i > 1))
            if i != self.t - 1:
                self.add_module(f"down_{i}", DownProjectionUnit(
                    (i + 1) * nr, nr, int(sr_scale),
                    dense_input=self.dense and i > 0))
        self.reconstruction = Conv(self.t * nr, in_chans, 3)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        f = _prelu(self.input_conv_0(x.to(self.dtype)))
        f = _prelu(self.input_conv_1(f))
        hs, ls = [], []
        for i in range(self.t):
            if i and self.dense:
                f = torch.cat(ls, dim=-1)
            f = getattr(self, f"up_{i}")(f)
            hs.append(f)
            if i != self.t - 1:
                if self.dense:
                    f = torch.cat(hs, dim=-1)
                f = getattr(self, f"down_{i}")(f)
                ls.append(f)
        return self.reconstruction(torch.cat(hs, dim=-1))


def make_dbpn(paras, mean=None, std=None, dtype=torch.float32) -> DBPN:
    """Factory keyed off the reference config names (``dbpn_*``)."""
    return DBPN(
        in_chans=paras.input_channel, n0=paras.get("dbpn_n0", 256),
        nr=paras.get("dbpn_nr", 64), t=paras.get("dbpn_t", 7),
        sr_scale=int(paras.sr_scale), dense=paras.get("dbpn_dense", True),
        dtype=dtype, train_resolution=(paras.patch_size,) * 2,
    ).eval()
