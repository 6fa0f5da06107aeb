"""The ResNet family with BatchNorm, the port of the JAX package's
``models/resnet.py`` (BASELINE.json's "ResNet-50 / CIFAR-10
data-parallel"; its metric is images a second).

Images are **[B, H, W, C]**, the JAX package's layout; the model views
them as NCHW with channels-last strides (a ``permute``, no copy), so
every convolution runs in ``torch.channels_last``.  Convolutions and
BatchNorm compute in ``cfg.dtype`` (bf16 by default) with fp32
statistics; the classifier runs in fp32 and returns fp32 logits.

Where flax and torch differ, the port takes flax's numbers:

- ``'SAME'`` padding is flax's rule, not a constant: a 3x3/2 convolution
  of an even input pads (0, 1), of an odd one (1, 1)
  (:func:`same_padding`);
- :class:`BatchNorm` keeps flax's statistics: the biased variance
  E[x^2] - E[x]^2 in fp32, eps 1e-5, running averages with flax's
  momentum 0.9 (torch's 0.1) of the biased variance (torch's keeps the
  unbiased one).  Under a plan the per-channel sums are all-reduced over
  the plan's batch axes (``stat_groups``, set by ``executor.apply_plan``),
  so the forward and its gradient both see the global batch, as GSPMD
  gives JAX;
- the running statistics are state, not parameters
  (``TrainState.model_state``): a forward with ``mutable=True`` returns
  the new ones beside the logits (flax's ``apply(..., mutable=)``) and
  writes none, so a forward that activation checkpointing re-runs in the
  backward moves nothing; the step commits them once a batch slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .transformer_core import Linear


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    small_inputs: bool = False  # CIFAR stem (3x3/1) vs ImageNet stem (7x7/2)

    def forward_flops_per_image(self, image_hw: tuple[int, int]) -> float:
        """Analytic convolution and dense FLOPs of one image's forward (2
        a multiply-add), walking :class:`ResNet`'s structure: the JAX
        package's count (8.18 GFLOPs for ResNet-50 at 224 x 224).
        BatchNorm, ReLU and pooling are left out, as MFU counts do."""
        h, w = image_hw

        def conv(k: int, cin: int, cout: int, stride: int = 1) -> float:
            nonlocal h, w
            h = -(-h // stride)  # 'SAME' padding output size
            w = -(-w // stride)
            return 2.0 * k * k * cin * cout * h * w

        total = 0.0
        if self.small_inputs:
            total += conv(3, 3, self.width)
        else:
            total += conv(7, 3, self.width, 2)
            h, w = -(-h // 2), -(-w // 2)  # 3x3/2 max-pool
        cin = self.width
        for i, n_blocks in enumerate(self.stage_sizes):
            f = self.width * 2**i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                bh, bw = h, w  # block input spatial dims (conv1 pre-stride)
                total += 2.0 * cin * f * bh * bw            # conv1 1x1
                total += conv(3, f, f, stride)              # conv2 3x3/s
                total += 2.0 * f * 4 * f * h * w            # conv3 1x1
                if cin != 4 * f or stride != 1:
                    total += 2.0 * cin * 4 * f * h * w      # proj 1x1/s
                cin = 4 * f
        total += 2.0 * cin * self.num_classes  # classifier head
        return total

    def train_step_flops(self, image_hw: tuple[int, int], batch: int) -> float:
        """Forward and backward model FLOPs a step (backward ~ 2x forward)."""
        return 3.0 * self.forward_flops_per_image(image_hw) * batch


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'``: (low, high) padding of one spatial dim that
    gives ``ceil(size / stride)`` outputs, the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` without bias: a [out, in, kh, kw] weight (flax's
    HWIO kernel transposed), cast to the input's dtype, with ``'SAME'``
    padding unless ``padding`` is given per side."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int | None = None):
        super().__init__(cin, cout, kernel, stride, bias=False)
        self.explicit = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if self.explicit is not None:
            pad = self.explicit
        else:
            (h0, h1), (w0, w1) = (same_padding(n, k, s) for n in x.shape[2:])
            if (h0, w0) == (h1, w1):
                pad = h0
            else:
                x, pad = F.pad(x, (w0, w1, h0, h1)), 0
        return F.conv2d(x, self.weight.to(x.dtype), None, s, pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of an NCHW tensor: parameters
    ``scale`` and ``bias``, running statistics ``mean`` and ``var``
    (buffers, flax's ``batch_stats``).  ``forward(x, train, updates)``:
    with ``train`` the batch's statistics normalize ``x`` and, when
    ``updates`` is a dict, the new running ones go into it under this
    module's buffer names; without, the running ones normalize.
    ``stat_groups``: the process groups the batch statistics are summed
    over (the plan's batch axes; none on one process)."""

    def __init__(self, features: int, *, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.stat_groups: tuple = ()
        self.path = ""  # this module's name in its model, set by ResNet

    def batch_stats(self, x: torch.Tensor):
        """fp32 per-channel mean and biased variance E[x^2] - E[x]^2 of
        the global batch: the sums, sums of squares and count all-reduced
        (differentiably) over ``stat_groups``."""
        xf = x.float()
        dims = (0, 2, 3)
        c = x.shape[1]
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), x.numel() // c)])
        if self.stat_groups:
            from torch.distributed.nn.functional import all_reduce

            for group in self.stat_groups:
                sums = all_reduce(sums, group=group)
        count = sums[-1]
        mean, mean2 = sums[:c] / count, sums[c:2 * c] / count
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor, train: bool,
                updates: dict | None = None) -> torch.Tensor:
        if train:
            mean, var = self.batch_stats(x)
            if updates is not None:
                m = self.momentum
                with torch.no_grad():
                    updates[self.path + "mean"] = m * self.mean + (1 - m) * mean
                    updates[self.path + "var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = x - mean.view(shape)  # fp32, as flax promotes
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = y * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3/stride -> 1x1 (x4) with BatchNorm after each and a
    projection where the shape changes; ``bn3`` starts at zero scale."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(cin, features, 1)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = Conv(features, 4 * features, 1)
        self.bn3 = BatchNorm(4 * features, dtype=dtype)
        if cin != 4 * features or stride != 1:
            self.proj_conv = Conv(cin, 4 * features, 1, stride)
            self.proj_bn = BatchNorm(4 * features, dtype=dtype)

    def forward(self, x, train: bool, updates: dict | None):
        y = torch.relu(self.bn1(self.conv1(x), train, updates))
        y = torch.relu(self.bn2(self.conv2(y), train, updates))
        y = self.bn3(self.conv3(y), train, updates)
        residual = x
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(x), train, updates)
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``stem_conv``/``stem_bn`` (3x3/1 for small inputs, else 7x7/2 and a
    3x3/2 max-pool), bottleneck blocks ``stage{i}_block{j}`` and the fp32
    ``classifier`` on the spatial mean: flax's module names, so a JAX
    path is the port's name with '/' for '.' (``interop.jax_param_path``).
    ``layers`` lists the blocks in order (FSDP2 wraps each, as it wraps
    a decoder's layers)."""

    # forward takes train= and mutable=, and the step threads the buffers
    stateful = True

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w, dt = cfg.width, cfg.dtype
        if cfg.small_inputs:
            self.stem_conv = Conv(3, w, 3)
        else:
            self.stem_conv = Conv(3, w, 7, 2, padding=3)
        self.stem_bn = BatchNorm(w, dtype=dt)
        blocks, cin = [], w
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                f = w * 2**i
                block = Bottleneck(cin, f, 2 if i > 0 and j == 0 else 1, dt)
                setattr(self, f"stage{i}_block{j}", block)
                blocks.append(block)
                cin = 4 * f
        self.layers = blocks  # a plain list: the modules are registered above
        self.classifier = Linear(cin, cfg.num_classes)
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.path = f"{name}."

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """flax's initializers: lecun-normal kernels (std 1/sqrt(fan_in),
        as the port's other families draw them), a zero classifier bias,
        BatchNorm scale 1 (``bn3``'s 0) and bias 0, running mean 0 and
        variance 1."""
        for name, mod in self.named_modules():
            if isinstance(mod, (Conv, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                   generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(0.0 if name.endswith("bn3") else 1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        return self

    def forward(self, x, train: bool = True, *, mutable: bool = False,
                generator: torch.Generator | None = None):
        """``x`` [B, H, W, C] -> fp32 logits [B, classes]; with
        ``mutable`` (and ``train``), ``(logits, new running statistics
        by buffer name)``.  ``generator`` is accepted for the loss
        signature (no dropout)."""
        cfg = self.cfg
        updates = {} if train and mutable else None
        x = torch.as_tensor(x).to(cfg.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.stem_bn(self.stem_conv(x), train, updates))
        if not cfg.small_inputs:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.layers:
            x = block(x, train, updates)
        # jnp.mean of the compute dtype: fp32 sums, rounded back to it
        x = x.float().mean((2, 3)).to(cfg.dtype).float()
        logits = F.linear(x, self.classifier.weight.float(),
                          self.classifier.bias.float())
        return logits if updates is None else (logits, updates)


def ResNet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(ResNetConfig(num_classes=num_classes, **kw))


def ResNet18Thin(num_classes: int = 10, **kw) -> ResNet:
    """The small variant of the tests and the CPU."""
    return ResNet(ResNetConfig(stage_sizes=(2, 2), num_classes=num_classes,
                               width=16, small_inputs=True, **kw))
