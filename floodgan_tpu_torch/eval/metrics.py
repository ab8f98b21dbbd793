"""The metric suite of the reference's torchmetrics configuration: the port
of floodgan_tpu/eval/metrics.py.

PSNR, SSIM and MS-SSIM with data range (0, 1), one value per image;
MSE / Accuracy / F1 / Precision / Recall / IoU of binary flood masks over
the whole split, from an accumulated confusion matrix (the reference
concatenates every pixel of the split, which is the same).

SSIM and MS-SSIM follow torchmetrics: an 11x11 Gaussian (sigma 1.5),
k1 = 0.01, k2 = 0.03, valid-region means; MS-SSIM's betas (0.0448, 0.2856,
0.3001, 0.2363, 0.1333), a 2x2 average pool between scales and relu
normalisation.  Images are NHWC tensors, on any device.

Precision: SSIM's variance form E[x^2] - mu^2 amplifies any rounding of
the Gaussian filters wherever the local variance is small.  On the TPU,
bf16 conv operands drove MS-SSIM's scale-5 CS to 1.157 (it is <= 1); on an
NVIDIA card the same hazard is TF32, which cuDNN uses for f32 convolutions
by default.  So the filters, depthwise ``F.conv2d`` with ``groups=C``, run
under ``core.device.full_f32()``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from floodgan_tpu_torch.core.device import full_f32
from floodgan_tpu_torch.data.transforms import denormalize

_MSSSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
# The smallest side MS-SSIM takes with the defaults: the last scale's
# 11-tap valid window must fit after four floor-halvings (11 * 2^4 = 176).
# torchmetrics documents (11 - 1) * 2^4 = 160, under which 161-175 px inputs
# reach an empty valid conv; callers gate on this and NaN the column.
MS_SSIM_MIN_SIDE = 11 * 2 ** (len(_MSSSIM_BETAS) - 1)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over all pixels and channels: 10 log10(range^2 / mse)."""
    mse = torch.mean(torch.square(pred - target), dim=tuple(range(1, pred.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse)


@functools.lru_cache(maxsize=8)
def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gaussian_filter_valid(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable valid-mode Gaussian over H, W of an NCHW tensor: two
    depthwise convolutions.  The caller holds ``full_f32()``."""
    c = x.shape[1]
    k = torch.from_numpy(_gaussian_1d(size, sigma)).to(x.device)
    x = F.conv2d(x, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


def _ssim_and_cs(pred, target, data_range: float, size: int, sigma: float):
    """Per-image (SSIM, CS) of NCHW tensors."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    with full_f32():
        mu_p = _gaussian_filter_valid(pred, size, sigma)
        mu_t = _gaussian_filter_valid(target, size, sigma)
        e_pp = _gaussian_filter_valid(pred * pred, size, sigma)
        e_tt = _gaussian_filter_valid(target * target, size, sigma)
        e_pt = _gaussian_filter_valid(pred * target, size, sigma)
    var_p = e_pp - mu_p * mu_p
    var_t = e_tt - mu_t * mu_t
    cov = e_pt - mu_p * mu_t
    cs_map = (2.0 * cov + c2) / (var_p + var_t + c2)
    ssim_map = ((2.0 * mu_p * mu_t + c1) / (mu_p * mu_p + mu_t * mu_t + c1)) * cs_map
    dims = tuple(range(1, pred.ndim))
    return ssim_map.mean(dim=dims), cs_map.mean(dim=dims)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Per-image SSIM, NHWC inputs."""
    return _ssim_and_cs(_nchw(pred), _nchw(target), data_range, kernel_size, sigma)[0]


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
            sigma: float = 1.5, betas: Tuple[float, ...] = _MSSSIM_BETAS,
            normalize: bool = True) -> torch.Tensor:
    """Per-image multi-scale SSIM, NHWC inputs whose smaller side is at least
    ``MS_SSIM_MIN_SIDE`` (176 for the defaults)."""
    pred, target = _nchw(pred), _nchw(target)
    vals = []
    for i in range(len(betas)):
        s, cs = _ssim_and_cs(pred, target, data_range, kernel_size, sigma)
        vals.append(s if i == len(betas) - 1 else cs)
        if i != len(betas) - 1:
            pred, target = F.avg_pool2d(pred, 2), F.avg_pool2d(target, 2)
    stack = torch.stack(vals)  # (scales, N)
    if normalize:
        stack = torch.clamp(stack, min=0.0)
    b = torch.tensor(betas, dtype=stack.dtype, device=stack.device)[:, None]
    return torch.prod(stack ** b, dim=0)


def image_pair_metrics(pred: torch.Tensor, target: torch.Tensor,
                       with_ms_ssim: bool = True) -> Dict[str, torch.Tensor]:
    """The per-image block of the metric table, on [0, 1] NHWC images
    (clamped again, as torchmetrics' tuple data range does)."""
    pred = torch.clamp(pred, 0.0, 1.0)
    target = torch.clamp(target, 0.0, 1.0)
    out = {"PSNR": psnr(pred, target), "SSIM": ssim(pred, target)}
    if with_ms_ssim:
        out["MS-SSIM"] = ms_ssim(pred, target)
    return out


# ----------------------------------------------------------- mask metrics

# The keys of MaskMetricsAccumulator.compute, in the metric CSVs' order.
MASK_METRICS = (
    "MSE", "Accuracy", "F1_Flood", "Precision_Flood", "Recall_Flood",
    "F1_No_Flood", "Precision_No_Flood", "Recall_No_Flood", "IoU_Flood", "IoU_No_Flood",
)


class MaskMetricsAccumulator:
    """Split-level binary mask metrics from an accumulated confusion matrix
    (tp, fp, fn, tn): MSE, Accuracy, and F1 / Precision / Recall / IoU of
    the flood masks and of the inverted (no-flood) masks."""

    def __init__(self):
        self.counts = np.zeros(4, dtype=np.int64)  # tp, fp, fn, tn

    def update(self, pred_mask: torch.Tensor, true_mask: torch.Tensor) -> None:
        self.add_counts(confusion_counts(pred_mask, true_mask))

    def add_counts(self, counts) -> None:
        """Add (tp, fp, fn, tn) counts: one vector, or a (B, 4) per-image
        stack (summed here, exactly)."""
        c = counts.cpu().numpy() if torch.is_tensor(counts) else np.asarray(counts)
        self.counts += c.astype(np.int64).reshape(-1, 4).sum(axis=0)

    def compute(self) -> Dict[str, float]:
        tp, fp, fn, tn = (float(v) for v in self.counts)
        total = tp + fp + fn + tn

        def prf(tp_, fp_, fn_):
            precision = tp_ / (tp_ + fp_) if tp_ + fp_ > 0 else 0.0
            recall = tp_ / (tp_ + fn_) if tp_ + fn_ > 0 else 0.0
            f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
            iou = tp_ / (tp_ + fp_ + fn_) if tp_ + fp_ + fn_ > 0 else 0.0
            return precision, recall, f1, iou

        p_f, r_f, f1_f, iou_f = prf(tp, fp, fn)
        p_n, r_n, f1_n, iou_n = prf(tn, fn, fp)  # inverted masks swap the roles
        return {
            "MSE": (fp + fn) / total if total else 0.0,
            "Accuracy": (tp + tn) / total if total else 0.0,
            "F1_Flood": f1_f,
            "Precision_Flood": p_f,
            "Recall_Flood": r_f,
            "F1_No_Flood": f1_n,
            "Precision_No_Flood": p_n,
            "Recall_No_Flood": r_n,
            "IoU_Flood": iou_f,
            "IoU_No_Flood": iou_n,
        }


def confusion_counts_per_image(pred_mask: torch.Tensor, true_mask: torch.Tensor) -> torch.Tensor:
    """(B, 4) per-image (tp, fp, fn, tn) of masks thresholded at 0.5, int64
    on the masks' device."""
    dims = tuple(range(1, pred_mask.ndim))
    p, t = pred_mask > 0.5, true_mask > 0.5
    return torch.stack([(p & t).sum(dims), (p & ~t).sum(dims), (~p & t).sum(dims), (~p & ~t).sum(dims)], dim=-1)


def confusion_counts(pred_mask: torch.Tensor, true_mask: torch.Tensor) -> torch.Tensor:
    """The batch's (tp, fp, fn, tn): the per-image form summed."""
    return confusion_counts_per_image(pred_mask, true_mask).sum(dim=0)


def make_eval_batch_metrics(seg_predict_mask):
    """The metric block of the eval loop, for one segmentation model.

    ``seg_predict_mask(image01) -> float mask`` is the seg trainer's own
    ``predict_mask``, so the sigmoid > 0.5 threshold is defined once.  The
    result is ``fn(out, y, with_ms_ssim=True) -> (per-image metric dict,
    per-image confusion counts (B, 4))`` on normalized ([-1, 1]) generator
    output and target.  Its two U-Net forwards stay separate: batch norm
    runs on batch statistics, so one forward over output and truth together
    would mix their statistics.

    Two attributes serve a comparison of several models, whose truth side
    is the same for each: ``fn.true_mask(y)`` computes the reference mask
    once a batch, and ``fn.with_true_mask(out, y, true_mask,
    with_ms_ssim=True)`` skips the y-side forward.

    Build it once per trainer (``SegTrainer`` does), not once per call.
    """

    def with_true_mask(out, y, true_mask, with_ms_ssim=True):
        out01 = denormalize(out)
        imgm = image_pair_metrics(out01, denormalize(y), with_ms_ssim=with_ms_ssim)
        return imgm, confusion_counts_per_image(seg_predict_mask(out01), true_mask)

    def true_mask_fn(y):
        return seg_predict_mask(denormalize(y))

    def eval_batch_metrics(out, y, with_ms_ssim=True):
        out01, y01 = denormalize(out), denormalize(y)
        imgm = image_pair_metrics(out01, y01, with_ms_ssim=with_ms_ssim)
        out_mask = seg_predict_mask(out01)
        return imgm, confusion_counts_per_image(out_mask, seg_predict_mask(y01))

    eval_batch_metrics.with_true_mask = with_true_mask
    eval_batch_metrics.true_mask = true_mask_fn
    return eval_batch_metrics
