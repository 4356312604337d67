"""IPT, the image-processing transformer for SR (counterpart of
``rdst_tpu/models/ipt.py``).

Per-scale conv heads and tails (``head_{si}_*`` / ``tail_{si}_*``, si the
scale's position in ``all_sr_scales``) around one encoder-decoder
transformer over the patch_dim x patch_dim tokens of the LR training
patch: bias-free multi-head attention, pre-LN layers, ReLU FFN, a learned
position table and one learned query table a scale. Both tables are sized
by the token count at init, so the model runs only at the training patch:
another input size raises and names both counts (the tester scores IPT
with ``tiled_inference = True``, as the JAX tester does). The attention is
the plain matmul + softmax the JAX package computes outside any Pallas
kernel.

In bfloat16 the float32 position and query tables make the token stream
float32 from their first addition on, as JAX's type promotion does; each
Dense and LayerNorm then rounds its input or output to bf16 as the flax
module at ``dtype=bfloat16`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.models.edsr import NoKernels
from rdst_tpu_torch.nn.common import (BF16, Conv, ResBlock, UpSampler,
                                      mean_shift, norm_buffers)
from rdst_tpu_torch.nn.layers import Dropout, LayerNorm, Linear, resolve_act


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention(bias=False)`` semantics on (B, L, D)
    tokens; the projections keep the flax names."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = int(dim), int(num_heads)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Linear(dim, dim, bias=False))

    def forward(self, q, k, v, dtype: torch.dtype) -> torch.Tensor:
        b, lq = q.shape[:2]
        nh, hd = self.num_heads, self.dim // self.num_heads

        def heads(x, proj):
            y = proj(x.to(dtype))
            return y.reshape(b, -1, nh, hd).transpose(1, 2)

        qh = heads(q, self.q_proj) * (hd ** -0.5)
        kh, vh = heads(k, self.k_proj), heads(v, self.v_proj)
        if dtype == BF16:  # each product and the softmax rounded to bf16
            attn = (qh.float() @ kh.float().transpose(2, 3)).to(BF16)
            attn = torch.softmax(attn.float(), -1).to(BF16)
            out = (attn.float() @ vh.float()).to(BF16)
        else:
            attn = torch.softmax(qh @ kh.transpose(2, 3), -1)
            out = attn @ vh
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, self.dim))


class _Layer(nn.Module):
    def _norm(self, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
        if self.no_norm:
            return x
        norm = getattr(self, name)
        return norm.bf16(x) if dtype == BF16 else norm(x)

    def _ffn(self, x, dtype):
        return self.drop(self.linear2(self.drop(F.relu(self.linear1(
            x.to(dtype))))))


class EncoderLayer(_Layer):
    def __init__(self, dim: int, num_heads: int, hidden: int,
                 dropout: float = 0.0, no_norm: bool = False):
        super().__init__()
        self.no_norm = bool(no_norm)
        if not self.no_norm:
            self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.linear1, self.linear2 = Linear(dim, hidden), Linear(hidden, dim)
        self.drop = Dropout(dropout)

    def forward(self, src, pos, dtype):
        src2 = self._norm("norm1", src, dtype)
        qk = src2 if pos is None else src2 + pos
        src = src + self.drop(self.self_attn(qk, qk, src2, dtype))
        return src + self._ffn(self._norm("norm2", src, dtype), dtype)


class DecoderLayer(_Layer):
    def __init__(self, dim: int, num_heads: int, hidden: int,
                 dropout: float = 0.0, no_norm: bool = False):
        super().__init__()
        self.no_norm = bool(no_norm)
        if not self.no_norm:
            self.norm1, self.norm2, self.norm3 = (LayerNorm(dim),
                                                  LayerNorm(dim),
                                                  LayerNorm(dim))
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.linear1, self.linear2 = Linear(dim, hidden), Linear(hidden, dim)
        self.drop = Dropout(dropout)

    def forward(self, tgt, memory, pos, query_pos, dtype):
        def with_pos(x, p):
            return x if p is None else x + p

        tgt2 = self._norm("norm1", tgt, dtype)
        qk = with_pos(tgt2, query_pos)
        tgt = tgt + self.drop(self.self_attn(qk, qk, tgt2, dtype))
        tgt2 = self._norm("norm2", tgt, dtype)
        tgt = tgt + self.drop(self.multihead_attn(
            with_pos(tgt2, query_pos), with_pos(memory, pos), memory, dtype))
        return tgt + self._ffn(self._norm("norm3", tgt, dtype), dtype)


class IPTBody(nn.Module):
    """The transformer over patch_dim x patch_dim tokens of a
    ``num_channels``-map image of ``tokens`` tokens."""

    def __init__(self, tokens: int, patch_dim: int, num_channels: int,
                 num_heads: int, num_layers: int, num_queries: int,
                 dropout: float = 0.0, no_norm: bool = False,
                 no_mlp: bool = False, pos_every: bool = False,
                 no_pos: bool = False):
        super().__init__()
        self.patch_dim, self.tokens = int(patch_dim), int(tokens)
        dim = num_channels * patch_dim * patch_dim
        hidden = 4 * dim
        self.num_layers = int(num_layers)
        self.no_mlp, self.pos_every, self.no_pos = no_mlp, pos_every, no_pos
        self.drop = Dropout(dropout)
        if not no_mlp:
            self.linear_encoding = Linear(dim, dim)
            self.query_embed = nn.Parameter(
                torch.zeros(num_queries, self.tokens * dim))
            self.mlp_head_0 = Linear(dim, hidden)
            self.mlp_head_1 = Linear(hidden, dim)
        if not no_pos:
            self.position_encoding = nn.Parameter(torch.zeros(self.tokens,
                                                              dim))
        for i in range(self.num_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(
                dim, num_heads, hidden, dropout, no_norm))
        for i in range(self.num_layers):
            self.add_module(f"decoder_{i}", DecoderLayer(
                dim, num_heads, hidden, dropout, no_norm))

    def forward(self, x: torch.Tensor, query_idx: int) -> torch.Tensor:
        b, h, w, c = x.shape
        pd, dtype = self.patch_dim, x.dtype
        lh, lw = h // pd, w // pd
        seq, dim = lh * lw, c * pd * pd
        if seq != self.tokens or lh * pd != h or lw * pd != w:
            raise ValueError(
                f"IPT's position and query tables hold {self.tokens} tokens "
                f"(the training patch), this {h}x{w} input gives {seq} "
                f"{pd}x{pd} tokens: IPT runs only at the training patch; "
                "score it with tiled_inference = True")
        tokens = x.reshape(b, lh, pd, lw, pd, c).permute(0, 1, 3, 5, 2, 4)
        tokens = tokens.reshape(b, seq, dim)
        query = None
        if not self.no_mlp:
            tokens = self.drop(self.linear_encoding(tokens)) + tokens
            query = self.query_embed[query_idx].reshape(1, seq, dim).expand(
                b, seq, dim)
        pos = None if self.no_pos else self.position_encoding[None]
        y = tokens
        if self.pos_every:
            enc_pos, dec_pos = pos, pos
        else:
            if pos is not None:
                y = y + pos
            enc_pos = dec_pos = None
        for i in range(self.num_layers):
            y = getattr(self, f"encoder_{i}")(y, enc_pos, dtype)
        memory = y
        for i in range(self.num_layers):
            y = getattr(self, f"decoder_{i}")(y, memory, dec_pos, query,
                                              dtype)
        if not self.no_mlp:
            h1 = self.drop(self.mlp_head_0(y.to(dtype)))
            h1 = self.drop(self.mlp_head_1(F.relu(h1)))
            y = h1 + y
        y = y.reshape(b, lh, lw, c, pd, pd).permute(0, 1, 4, 2, 5, 3)
        return y.reshape(b, h, w, c)


class IPT(NoKernels, nn.Module):
    """``forward(x, sr_scale)`` on NHWC tensors of the training patch's
    size; the scale is required and must be one of ``sr_scales``."""

    def __init__(self, sr_scales: Sequence[float], patch: int,
                 in_chans: int = 1, n_feats: int = 64, patch_dim: int = 3,
                 num_heads: int = 12, num_layers: int = 12,
                 num_queries: int = 3, dropout: float = 0.0,
                 no_norm: bool = False, no_mlp: bool = False,
                 pos_every: bool = False, no_pos: bool = False,
                 act: str = "relu", mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._no_kernels(dtype, (patch, patch))
        self.sr_scales = tuple(float(s) for s in sr_scales)
        norm_buffers(self, mean, std)
        for si, s in enumerate(self.sr_scales):
            self.add_module(f"head_{si}_conv", Conv(in_chans, n_feats, 3))
            self.add_module(f"head_{si}_res0", ResBlock(n_feats, 5, act))
            self.add_module(f"head_{si}_res1", ResBlock(n_feats, 5, act))
            self.add_module(f"tail_{si}_up", UpSampler(int(s), n_feats))
            self.add_module(f"tail_{si}_conv", Conv(n_feats, in_chans, 3))
        self.body = IPTBody((patch // patch_dim) ** 2, patch_dim, n_feats,
                            num_heads, num_layers, num_queries, dropout,
                            no_norm, no_mlp, pos_every, no_pos)

    def forward(self, x: torch.Tensor, sr_scale=None) -> torch.Tensor:
        if sr_scale is None or float(sr_scale) not in self.sr_scales:
            raise ValueError(f"IPT has branches for scales {self.sr_scales} "
                             f"(all_sr_scales), not {sr_scale}")
        si = self.sr_scales.index(float(sr_scale))
        x = mean_shift(x.to(self.dtype), self.norm_mean, self.norm_std, "sub")
        y = getattr(self, f"head_{si}_conv")(x)
        y = getattr(self, f"head_{si}_res0")(y)
        y = getattr(self, f"head_{si}_res1")(y)
        res = self.body(y, si) + y
        out = getattr(self, f"tail_{si}_up")(res.to(self.dtype))
        out = getattr(self, f"tail_{si}_conv")(out)
        return mean_shift(out, self.norm_mean, self.norm_std, "add")


def make_ipt(paras, mean=None, std=None, dtype=torch.float32) -> IPT:
    """Factory keyed off the config's ``[IPT]`` section: a branch a scale
    of ``all_sr_scales``, the tables sized by ``patch_size``."""
    c = paras.input_channel
    return IPT(
        sr_scales=paras.all_sr_scales, patch=int(paras.patch_size),
        in_chans=c, n_feats=paras.ipt_n_feats, patch_dim=paras.ipt_patch_dim,
        num_heads=paras.ipt_num_heads, num_layers=paras.ipt_num_layers,
        num_queries=paras.ipt_num_queries, dropout=paras.ipt_dropout_rate,
        no_norm=paras.ipt_no_norm, no_mlp=paras.ipt_no_mlp,
        pos_every=paras.ipt_pos_every, no_pos=paras.ipt_no_pos,
        act=resolve_act(paras, paras.ipt_act),
        mean=tuple(mean) if mean is not None else (0.0,) * c,
        std=tuple(std) if std is not None else (1.0,) * c,
        dtype=dtype,
    ).eval()
