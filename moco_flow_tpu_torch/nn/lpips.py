"""LPIPS perceptual distance (AlexNet backbone).

Port of ``moco_flow_tpu/nn/lpips.py``, the official LPIPS v0.1 'alex'
configuration (Zhang et al., CVPR 2018): inputs in [0, 1] are mapped to
[-1, 1], passed through the ImageNet scaling layer, then the 5 AlexNet conv
feature taps are channel-unit-normalized, squared-differenced, reduced by
the learned 1x1 linear calibration weights, spatially averaged and summed.
The convolutions are ``F.conv2d`` in fp32 (TF32 off).

Weights come from the same ``.npz`` as the JAX package's (``conv{i}_w``
(O, I, kh, kw), ``conv{i}_b``, ``lin{i}_w`` (C,)): ``$LPIPS_WEIGHTS_NPZ`` or
``weights=``; ``scripts/export_lpips_weights.py`` writes the file where the
``lpips`` package is installed. Callers gate on :func:`available`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet 'features' stack: (out_ch, kernel, stride, pad); taps after each relu
_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # maxpool k3 s2 after relu1 and relu2
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def available(weights=None) -> bool:
    return weights is not None or bool(os.environ.get("LPIPS_WEIGHTS_NPZ"))


def load_weights(path: str | None = None) -> dict:
    """Load {conv{i}_w, conv{i}_b, lin{i}_w} (float32 numpy) from npz."""
    path = path or os.environ.get("LPIPS_WEIGHTS_NPZ")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights npz not found; set $LPIPS_WEIGHTS_NPZ or export "
            "them with scripts/export_lpips_weights.py (needs the `lpips` "
            "pip package).")
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def random_weights(seed: int = 0) -> dict:
    """Random-but-shaped weights (tests / smoke only — NOT perceptual)."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    in_ch = 3
    for i, (oc, k, _, _) in enumerate(_CONVS):
        out[f"conv{i}_w"] = (torch.randn((oc, in_ch, k, k), generator=gen)
                             * 0.05).numpy()
        out[f"conv{i}_b"] = np.zeros((oc,), np.float32)
        out[f"lin{i}_w"] = (torch.randn((oc,), generator=gen).abs()
                            * 0.01).numpy()
        in_ch = oc
    return out


def _features(w: dict, x: torch.Tensor) -> list:
    """x: (B, 3, H, W) in [-1, 1] -> 5 conv taps (post-relu)."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                            stride=stride, padding=pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def _unit_normalize(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return t / torch.sqrt(torch.sum(t * t, dim=1, keepdim=True) + eps)


def lpips(weights: dict, img0: torch.Tensor, img1: torch.Tensor
          ) -> torch.Tensor:
    """Perceptual distance between (B, 3, H, W) images in [0, 1] -> (B,)."""
    dev = img0.device
    w = {k: torch.tensor(np.asarray(v, np.float32), device=dev)
         for k, v in weights.items()}
    with torch.backends.cudnn.flags(allow_tf32=False):
        a = _features(w, img0.float() * 2.0 - 1.0)
        b = _features(w, img1.float() * 2.0 - 1.0)
    total = 0.0
    for i, (fa, fb) in enumerate(zip(a, b)):
        d = (_unit_normalize(fa) - _unit_normalize(fb)) ** 2
        lin = w[f"lin{i}_w"].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * lin, dim=1), dim=(1, 2))
    return total
