"""Perceptual losses (port of ``vision_pt_tpu/ops/loss/perceptual.py``):
gaussian SSIM, and LPIPS over VGG16 features with learned 1x1 heads.

Images are NHWC at the public functions, as in the JAX package; inside, the
convolutions run over NCHW. LPIPS loads its weights from a local file
(torchvision's VGG16 ``features``, an lpips / torchmetrics state dict, or
safetensors); nothing is downloaded.
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from ...utils import resolve_device

PerceptualLossType = Literal["ssim", "lpips"]


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (coords / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 2.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean gaussian SSIM per batch element of (B, H, W, C) images
    (torchmetrics' definition, over the valid windows)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    channels = x.shape[-1]
    kernel = _gaussian_kernel(kernel_size, sigma).to(x.device)
    kernel = kernel.expand(channels, 1, kernel_size, kernel_size)

    def blur(img):
        return F.conv2d(img.float().permute(0, 3, 1, 2), kernel, groups=channels)

    mu_x, mu_y = blur(x), blur(y)
    mu_xx, mu_yy, mu_xy = blur(x * x), blur(y * y), blur(x * y)
    var_x = mu_xx - mu_x**2
    var_y = mu_yy - mu_y**2
    cov = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_loss(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    """1 - SSIM, mean over the batch."""
    return torch.mean(1.0 - ssim(x, y, **kw))


# ---------------------------------------------------------------- LPIPS
#
# The lpips package's math (which torchmetrics wraps): VGG16 features at
# relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each unit-normalized over
# its channels, their squared difference weighted by a learned 1x1 head,
# averaged over the image, summed over the five stages.

# the channel plan of each stage of torchvision's VGG16 ``features``
_VGG16_STAGES = [
    [(3, 64), (64, 64)],
    [(64, 128), (128, 128)],
    [(128, 256), (256, 256), (256, 256)],
    [(256, 512), (512, 512), (512, 512)],
    [(512, 512), (512, 512), (512, 512)],
]
# the ``features.{idx}`` index of each conv, by stage, and where each of the
# lpips package's slices starts
_VGG16_CONV_IDX = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
_SLICE_START = [0, 4, 9, 16, 23]
# the lpips input scaling layer
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def load_lpips_weights(weights_path: str) -> dict:
    """LPIPS-VGG parameters from a local file, its layout found by its keys:
    the lpips package or torchmetrics (``net.slice{k}.{idx}.weight`` convs,
    ``lin{k}.model.1.weight`` or ``lins.{k}.model.1.weight`` heads), or
    torchvision's VGG16 (``features.{idx}.weight``, heads as ``lin{k}.weight``
    if any). A head the file lacks is uniform 1/C, the unlearned baseline.
    Returns ``{"convs": [[(weight (out, in, 3, 3), bias), ...] per stage],
    "lins": [(C,) per stage]}``, fp32 on the CPU."""
    if weights_path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(weights_path)
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)

    def get(*names):
        for n in names:
            if n in sd:
                return sd[n].float()
        return None

    convs, lins = [], []
    for k, (stage, idxs) in enumerate(zip(_VGG16_STAGES, _VGG16_CONV_IDX)):
        stage_convs = []
        for j, idx in enumerate(idxs):
            names = (f"net.slice{k + 1}.{idx}", f"net.net.slice{k + 1}.{idx}",
                     f"features.{idx}", f"slice{k + 1}.{idx - _SLICE_START[k]}")
            w = get(*(n + ".weight" for n in names))
            b = get(*(n + ".bias" for n in names))
            if w is None:
                raise ValueError(f"LPIPS weights at {weights_path} missing VGG conv "
                                 f"stage {k + 1} (features.{idx})")
            stage_convs.append((w, b if b is not None else torch.zeros(stage[j][1])))
        convs.append(stage_convs)
        lin = get(f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight", f"lin{k}.weight")
        channels = stage[-1][1]
        lins.append(torch.full((channels,), 1.0 / channels) if lin is None
                    else lin.reshape(-1))
    return {"convs": convs, "lins": lins}


def _params_to(params: dict, device) -> dict:
    return {"convs": [[(w.to(device), b.to(device)) for w, b in stage]
                      for stage in params["convs"]],
            "lins": [lin.to(device) for lin in params["lins"]]}


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


def lpips_from_params(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per batch element of (B, H, W, 3) images in [0, 1];
    differentiable. ``params`` lie on the images' device."""
    shift = torch.tensor(_LPIPS_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_LPIPS_SCALE, device=x.device).reshape(1, 3, 1, 1)

    def prep(img):  # lpips' normalize=True, then its scaling layer
        return (img.float().permute(0, 3, 1, 2) * 2.0 - 1.0 - shift) / scale

    fx, fy = prep(x), prep(y)
    total = torch.zeros(x.shape[0], device=x.device)
    for k, (stage_convs, lin) in enumerate(zip(params["convs"], params["lins"])):
        if k > 0:
            fx, fy = F.max_pool2d(fx, 2), F.max_pool2d(fy, 2)
        for w, b in stage_convs:
            fx = F.relu(F.conv2d(fx, w, b, padding=1))
            fy = F.relu(F.conv2d(fy, w, b, padding=1))
        diff = torch.square(_unit_normalize(fx) - _unit_normalize(fy))
        total = total + torch.einsum("bchw,c->bhw", diff, lin).mean(dim=(1, 2))
    return total


class LPIPS:
    """LPIPS with local pretrained weights (``weights_path``) or ``params``
    as :func:`load_lpips_weights` returns them, kept on ``device`` (the CUDA
    device unless the caller asks for another). Inputs are NHWC in [0, 1]."""

    def __init__(self, weights_path: str | None = None, params: dict | None = None,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
        if params is None and weights_path is None:
            raise ValueError(
                "LPIPS needs pretrained VGG weights on local disk: pass "
                "weights_path (torchvision vgg16 .pth, lpips/torchmetrics "
                "state dict, or a safetensors export). SSIM needs no weights.")
        if params is None:
            params = load_lpips_weights(weights_path)
        self.params = _params_to(params, device)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lpips_from_params(self.params, x, y)


class PerceptualLoss:
    """A weighted sum of perceptual losses: a dict of each named loss and
    ``total``. Inputs may be in [-1, 1] (``convert_zero_to_one``): LPIPS
    runs on [0, 1], clipped."""

    def __init__(self, losses: dict[PerceptualLossType, float] | None = None,
                 data_range: float = 2.0, lpips_weights_path: str | None = None,
                 convert_zero_to_one: bool = True,
                 device: str | torch.device | None = None):
        self.weights = losses or {"ssim": 1.0}
        self.data_range = data_range
        self.convert_zero_to_one = convert_zero_to_one
        self.lpips = (LPIPS(lpips_weights_path, device=device)
                      if "lpips" in self.weights else None)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> dict[str, torch.Tensor]:
        out: dict[str, torch.Tensor] = {}
        total = 0.0
        for name, weight in self.weights.items():
            if name == "ssim":
                value = ssim_loss(pred, target, data_range=self.data_range)
            elif name == "lpips":
                p, t = pred, target
                if self.convert_zero_to_one:
                    p, t = (p + 1.0) / 2.0, (t + 1.0) / 2.0
                value = torch.mean(self.lpips(torch.clamp(p, 0.0, 1.0),
                                              torch.clamp(t, 0.0, 1.0)))
            else:
                raise ValueError(f"Unknown perceptual loss: {name}")
            out[name] = value
            total = total + weight * value
        out["total"] = total
        return out
