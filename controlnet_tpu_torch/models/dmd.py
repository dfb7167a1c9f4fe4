"""Distribution-matching distillation (DMD) of the DDPM ControlNet.

Port of ``controlnet_tpu/models/dmd.py``:

* ``FeatureExtractor``: a frozen 4-stage conv pyramid (conv-BN-ReLU x2 per
  stage, strides 1/2/2/2, 32 base channels for one image channel, 64 for
  RGB), Kaiming-normal (fan_out) weights from a seed.  Its parameters take
  no gradient; gradients still flow through it to the student.
* ``DistributionMatchingControlNet``: an x0-predicting UNet student with a
  zero-initialised last hint conv and an integer timestep.
* ``DistributionMatchingDistilled``: the student, the frozen ControlNet
  teacher (epsilon -> clamped x0) and the feature extractor; feature-moment
  matching (mean + var + 0.1 skew, biased variance as ``jnp.var``), a
  sorted-pixel Wasserstein-1 approximation, Gram matrices over channels,
  weighted 1.0 / 0.5 / 0.3 / 0.1 with the pixel MSE, and total = alpha *
  teacher MSE + (1 - alpha) * dmd with alpha 0.3.  Both x0 are cast to
  float32 before every loss, so the feature extractor runs in float32.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.models.consistency import run_unet
from controlnet_tpu_torch.models.controlnet import ControlNet, fixed_hint_block
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.nn.layers import (BatchNorm, Conv2d, Linear, Sequential,
                                            get_time_embedding)
from controlnet_tpu_torch.schedules.linear import eps_to_x0, make_linear_schedule


class _FeatureStage(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3)
        self.bn2 = BatchNorm(cout)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), mesh))
        return F.relu(self.bn2(self.conv2(x), mesh))


class FeatureExtractor(nn.Module):
    """Frozen multi-scale conv features; returns the 4 stages' outputs.  Its
    BatchNorm statistics are the global batch's under a data-parallel
    ``mesh``."""

    def __init__(self, in_channels: int = 1, seed: int = 0):
        super().__init__()
        base = 32 if in_channels == 1 else 64
        chans = [(in_channels, base, 1), (base, base * 2, 2), (base * 2, base * 4, 2),
                 (base * 4, base * 8, 2)]
        self.stages = nn.ModuleList(_FeatureStage(*c) for c in chans)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv2d):
                    fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                    m.bias.zero_()
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, mesh=None) -> list[torch.Tensor]:
        feats = []
        for stage in self.stages:
            x = stage(x, mesh)
            feats.append(x)
        return feats


class DistributionMatchingControlNet(nn.Module):
    """x0-predicting student with a zero-initialised last hint conv."""

    def __init__(self, im_channels: int, model_config: Mapping[str, Any]):
        super().__init__()
        self.unet = UNet(im_channels, model_config)
        self.hint_block = fixed_hint_block(model_config["hint_channels"],
                                           self.unet.down_channels[0], zero_init=True)
        self.t_emb_dim = model_config["time_emb_dim"]
        self.t_proj = Sequential(nn.SiLU(), Linear(self.t_emb_dim, self.t_emb_dim))

    def forward(self, x_t: torch.Tensor, t, hint: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x_t.device).to(torch.int32)
        t_emb = self.t_proj(get_time_embedding(t, self.t_emb_dim))
        return run_unet(self.unet, x_t, self.hint_block(hint), t_emb)


class DistributionMatchingDistilled(nn.Module):
    """Student + frozen ControlNet teacher + frozen feature extractor, on
    ``device`` (None is the card).  Only ``student`` trains."""

    def __init__(self, im_channels: int, model_config: Mapping[str, Any],
                 num_timesteps: int = 1000, feature_seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.student = DistributionMatchingControlNet(im_channels, model_config)
        self.teacher = ControlNet(im_channels, model_config, model_locked=True)
        self.teacher.requires_grad_(False)
        self.feature_extractor = FeatureExtractor(im_channels, seed=feature_seed)
        self.teacher_schedule = make_linear_schedule(num_timesteps, 0.0001, 0.02, device=device)
        self.to(device)

    def teacher_prediction(self, x_t: torch.Tensor, t: torch.Tensor,
                           hint: torch.Tensor) -> torch.Tensor:
        """The frozen teacher's epsilon turned into a clamped x0."""
        with torch.no_grad():
            noise_pred = self.teacher(x_t, t, hint)
        return eps_to_x0(self.teacher_schedule, x_t, noise_pred, t)

    @staticmethod
    def _batch_moments(flat: torch.Tensor, mesh=None):
        """Mean, biased variance and third central moment over the batch
        axis of (B, N) ``flat``: over the global batch under a ``mesh``, each
        rank holding its rows (two passes, the sums reduced over the group)."""
        if mesh is None:
            mean = flat.mean(dim=0)
            return mean, flat.var(dim=0, correction=0), ((flat - mean) ** 3).mean(dim=0)
        from controlnet_tpu_torch.parallel.mesh import all_reduce_sum

        n = flat.shape[0] * mesh.data_size
        mean = all_reduce_sum(flat.sum(dim=0), mesh) / n
        d = flat - mean
        var, skew = all_reduce_sum(torch.stack([(d * d).sum(dim=0), (d ** 3).sum(dim=0)]),
                                   mesh) / n
        return mean, var, skew

    @staticmethod
    def feature_distribution_matching_loss(pred_features, target_features,
                                           mesh=None) -> torch.Tensor:
        """Batch moments per feature position: mean + var + 0.1 * skew, the
        variance biased (``jnp.var``), averaged over the levels; the moments
        of the global batch under a ``mesh``."""
        moments = DistributionMatchingDistilled._batch_moments
        total = 0.0
        for pf, tf in zip(pred_features, target_features):
            p_mean, p_var, p_skew = moments(pf.reshape(pf.shape[0], -1), mesh)
            t_mean, t_var, t_skew = moments(tf.reshape(tf.shape[0], -1), mesh)
            mean_loss = torch.mean((p_mean - t_mean) ** 2)
            var_loss = torch.mean((p_var - t_var) ** 2)
            skew_loss = torch.mean((p_skew - t_skew) ** 2)
            total = total + mean_loss + var_loss + 0.1 * skew_loss
        return total / len(pred_features)

    @staticmethod
    def wasserstein_distance_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Sorted-pixel L1, each sample's pixels sorted on their own."""
        p_sorted = torch.sort(pred.reshape(pred.shape[0], -1), dim=1).values
        t_sorted = torch.sort(target.reshape(target.shape[0], -1), dim=1).values
        return torch.mean(torch.abs(p_sorted - t_sorted))

    @staticmethod
    def gram_matrix_loss(pred_features, target_features) -> torch.Tensor:
        """Gram matrices over channels, f f^T on (B, C, HW) / (C H W)."""
        total = 0.0
        for pf, tf in zip(pred_features, target_features):
            b, c, h, w = pf.shape
            pr, tr = pf.reshape(b, c, h * w), tf.reshape(b, c, h * w)
            p_gram = torch.matmul(pr, pr.transpose(1, 2)) / (c * h * w)
            t_gram = torch.matmul(tr, tr.transpose(1, 2)) / (c * h * w)
            total = total + torch.mean((p_gram - t_gram) ** 2)
        return total / len(pred_features)

    def true_distribution_matching_loss(self, x0_pred: torch.Tensor, x0_target: torch.Tensor,
                                        mesh=None):
        """1.0 feature moments + 0.5 Wasserstein + 0.3 Gram + 0.1 pixel MSE
        on both x0 clipped to [-1, 1].  Returns (total, components).  Under a
        data-parallel ``mesh`` the batch statistics (the extractor's
        BatchNorm, the feature moments) are the global batch's; the other
        terms are means over this rank's rows, which the averaged gradient
        makes global."""
        x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        x0_target = torch.clamp(x0_target, -1.0, 1.0)
        pred_feats = self.feature_extractor(x0_pred, mesh)
        target_feats = self.feature_extractor(x0_target, mesh)
        feature_dist = self.feature_distribution_matching_loss(pred_feats, target_feats, mesh)
        wasserstein = self.wasserstein_distance_loss(x0_pred, x0_target)
        gram = self.gram_matrix_loss(pred_feats, target_feats)
        pixel = torch.mean((x0_pred - x0_target) ** 2)
        total = 1.0 * feature_dist + 0.5 * wasserstein + 0.3 * gram + 0.1 * pixel
        return total, {"feature_dist": feature_dist, "wasserstein": wasserstein, "gram": gram,
                       "pixel": pixel}

    def distillation_loss(self, x_t: torch.Tensor, t: torch.Tensor, hint: torch.Tensor,
                          x0_target: torch.Tensor, alpha: float = 0.3,
                          compute_dtype: torch.dtype | None = None, mesh=None):
        """total = alpha * teacher MSE + (1 - alpha) * dmd; the networks run in
        ``compute_dtype``, every loss in float32 (batch statistics over the
        global batch under ``mesh``).  Returns (total, dmd, teacher,
        components)."""
        cd = compute_dtype or x_t.dtype
        x_tc, hint_c = x_t.to(cd), hint.to(cd)
        x0_student = self.student(x_tc, t, hint_c).float()
        x0_teacher = self.teacher_prediction(x_tc, t, hint_c).float()
        dmd_loss, components = self.true_distribution_matching_loss(x0_student, x0_target,
                                                                    mesh)
        teacher_loss = torch.mean((x0_student - x0_teacher) ** 2)
        total = alpha * teacher_loss + (1.0 - alpha) * dmd_loss
        return total, dmd_loss, teacher_loss, components
