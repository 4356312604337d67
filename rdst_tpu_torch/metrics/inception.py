"""InceptionV3 pool3 features for FID (counterpart of
``rdst_tpu/metrics/inception.py``), in PyTorch on NCHW tensors.

The same network as the JAX module: torchvision's inception_v3 up to the
final average pool (2048 features, FID block 3), with pytorch-fid's FID
variants of the pooling inside InceptionA/C/E (average pools that do not
count the padding; the last InceptionE max-pools). The modules carry
pytorch-fid's names, so the ``pt_inception-2015-12-05-6726825d.pth``
state dict loads as it is (:func:`load_fid_inception`; its ``fc`` and
``AuxLogits`` entries are dropped). No weights ship with the repo: the
FID falls back as the JAX package's does (``metrics/fid.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rdst_tpu_torch.nn.layers import BatchNorm


class ConvBNRelu(nn.Module):
    """torchvision's BasicConv2d: conv (no bias), BN (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=stride,
                              padding=tuple(padding), bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    """3x3 stride-1 average pool that does not count the padding."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBNRelu(cin, 64, (1, 1))
        self.branch5x5_1 = ConvBNRelu(cin, 48, (1, 1))
        self.branch5x5_2 = ConvBNRelu(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = ConvBNRelu(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBNRelu(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBNRelu(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = ConvBNRelu(cin, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBNRelu(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = ConvBNRelu(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBNRelu(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBNRelu(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBNRelu(cin, 192, (1, 1))
        self.branch7x7_1 = ConvBNRelu(cin, c7, (1, 1))
        self.branch7x7_2 = ConvBNRelu(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBNRelu(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBNRelu(cin, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBNRelu(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBNRelu(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBNRelu(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBNRelu(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBNRelu(cin, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBNRelu(cin, 192, (1, 1))
        self.branch3x3_2 = ConvBNRelu(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = ConvBNRelu(cin, 192, (1, 1))
        self.branch7x7x3_2 = ConvBNRelu(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBNRelu(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBNRelu(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg' (the first, padding not counted) or 'max'."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = ConvBNRelu(cin, 320, (1, 1))
        self.branch3x3_1 = ConvBNRelu(cin, 384, (1, 1))
        self.branch3x3_2a = ConvBNRelu(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBNRelu(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBNRelu(cin, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBNRelu(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = ConvBNRelu(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBNRelu(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBNRelu(cin, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (_avg_pool(x) if self.pool_mode == "avg"
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Pool3(nn.Module):
    """Features up to the 2048-d global average pool, on NCHW inputs in
    [0, 1] (3 channels, resized to 299 by the caller)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBNRelu(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = ConvBNRelu(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBNRelu(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = ConvBNRelu(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = ConvBNRelu(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = 2.0 * x - 1.0  # pytorch-fid's normalize_input
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # (N, 2048)


def load_fid_inception(path: str) -> InceptionV3Pool3:
    """A pytorch-fid checkpoint as an :class:`InceptionV3Pool3`."""
    from rdst_tpu_torch.checkpoint.loading import read_torch_state_dict

    sd = read_torch_state_dict(path)
    keep = {k: v for k, v in sd.items()
            if not k.startswith(("fc.", "AuxLogits."))
            and not k.endswith("num_batches_tracked")}
    model = InceptionV3Pool3()
    model.load_state_dict(keep)
    return model.eval()


class InceptionFeatures:
    """Callable feature extractor for the FID, batched by ``batch_size``:
    HWC images in, (N, 2048) float32 features out. Each batch is resized
    to 299x299 by the linear resample matrices of the JAX package's
    ``resize_nhwc``; a batch of mixed sizes is resized image by image."""

    def __init__(self, model: InceptionV3Pool3, batch_size: int = 16,
                 device="cpu"):
        self.model = model.to(device).eval()
        self.batch_size = batch_size
        self.device = torch.device(device)

    def _resize(self, x: torch.Tensor) -> torch.Tensor:
        from rdst_tpu_torch.data.ops import resample_matrix

        h, w = x.shape[2:]
        if (h, w) == (299, 299):
            return x
        rm = torch.from_numpy(resample_matrix(h, 299, "linear")).float()
        cm = torch.from_numpy(resample_matrix(w, 299, "linear")).float()
        x = torch.einsum("oh,nchw->ncow", rm.to(x.device), x)
        return torch.einsum("pw,ncow->ncop", cm.to(x.device), x)

    @torch.no_grad()
    def _flush(self, batch) -> np.ndarray:
        def nchw(imgs):
            return torch.from_numpy(np.stack(imgs)).to(
                self.device).permute(0, 3, 1, 2)

        if all(b.shape == batch[0].shape for b in batch):
            x = self._resize(nchw(batch))
        else:
            x = torch.cat([self._resize(nchw([b])) for b in batch])
        return self.model(x).float().cpu().numpy()

    def __call__(self, imgs) -> np.ndarray:
        feats, batch = [], []
        for img in imgs:
            img = np.asarray(img, dtype=np.float32)
            if img.ndim == 2:
                img = img[:, :, None]
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            batch.append(img)
            if len(batch) == self.batch_size:
                feats.append(self._flush(batch))
                batch = []
        if batch:
            feats.append(self._flush(batch))
        return np.concatenate(feats)
