"""Inception-v1 I3D (Carreira & Zisserman) as ``nn.Module``s (port of
``ctc_tpu/models/i3d.py``).

* The submodules carry the reference PyTorch I3D's names
  (``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1b.bn.running_mean``,
  ``logits.conv3d.bias``), so one of its checkpoints loads with
  ``load_state_dict`` as it is (BatchNorm's ``num_batches_tracked``
  included).
* The input contract is ``ctc_tpu``'s channels-last ``[B, T, stack, h, w,
  3]`` (or ``[B, stack, h, w, 3]``): T is folded into the batch and the
  clips are permuted once to ``N, C, D, H, W``.  That permute of a
  channels-last tensor is a ``channels_last_3d`` view, so no copy is made.
* TF-"same" padding is XLA's rule, which is asymmetric at stride 2: total
  ``max((ceil(n / s) - 1) s + k - n, 0)``, ``total // 2`` in front
  (``Conv3d_1a_7x7`` on 10 frames pads 2 before and 3 after).  The
  convolutions pad with zeros; the 13 max pools take XLA's -inf padding,
  which ``ops/max_pool.py::max_pool3d_same`` keeps by skipping the window
  taps outside the tensor: on the card one hand-written kernel
  (``csrc/max_pool3d_same.cu``) with no padded copy, and a uint8 tap
  beside each output only where autograd needs it; on the CPU its plain
  version.
* BatchNorm is flax's, not ``nn.BatchNorm3d``'s: eps 1e-3, flax momentum
  0.99 (torch's 0.01), statistics by ``E[x^2] - E[x]^2`` clipped at 0, and
  the running variance updated with the *biased* batch variance.
* ``dtype`` is the convolutions' compute dtype (None: float32), and
  ``act_dtype`` the dtype of the activations between layers; parameters
  and BatchNorm statistics stay float32.  A model cast by ``.double()``
  with ``act_dtype`` float64 computes in float64 throughout: the exact
  step that the f32 finetune step is held to.

A float32 convolution on the card runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; :func:`full_f32_precision`
sets it so, and the entry points call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ctc_tpu_torch.models.lstm import dropout, lecun_normal_
from ctc_tpu_torch.ops.max_pool import max_pool3d_same, same_pads
from ctc_tpu_torch.utils.profiling import span

# (endpoint name, builder spec) in chain order
ENDPOINTS = (
    ("Conv3d_1a_7x7", ("unit", 64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", ("pool", (1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", ("unit", 64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", ("unit", 192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", ("pool", (1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", ("mixed", (64, 96, 128, 16, 32, 32))),
    ("Mixed_3c", ("mixed", (128, 128, 192, 32, 96, 64))),
    ("MaxPool3d_4a_3x3", ("pool", (3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", ("mixed", (192, 96, 208, 16, 48, 64))),
    ("Mixed_4c", ("mixed", (160, 112, 224, 24, 64, 64))),
    ("Mixed_4d", ("mixed", (128, 128, 256, 24, 64, 64))),
    ("Mixed_4e", ("mixed", (112, 144, 288, 32, 64, 64))),
    ("Mixed_4f", ("mixed", (256, 160, 320, 32, 128, 128))),
    ("MaxPool3d_5a_2x2", ("pool", (2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", ("mixed", (256, 160, 320, 32, 128, 128))),
    ("Mixed_5c", ("mixed", (384, 192, 384, 48, 128, 128))),
)

FEATURE_DIM = 1024


def pool_shapes(n: int, frames: int = 10, size: int = 224) -> list:
    """The chain's 13 max pools on ``n`` clips of ``frames`` x ``size`` x
    ``size``: ``(name, input [N, C, D, H, W], kernel, stride)`` in chain
    order, branch 3 of a ``Mixed_*`` block named ``<block>/b3``."""
    dhw, channels, pools = [frames, size, size], 3, []
    for name, spec in ENDPOINTS:
        if spec[0] == "unit":
            _, channels, kernel, stride = spec
        elif spec[0] == "pool":
            kernel, stride = spec[1:]
            pools.append((name, (n, channels, *dhw), kernel, stride))
        else:
            kernel, stride = (3, 3, 3), (1, 1, 1)
            pools.append((f"{name}/b3", (n, channels, *dhw), kernel, stride))
            oc = spec[1]
            channels = oc[0] + oc[2] + oc[4] + oc[5]
        dhw = [-(-d // s) for d, s in zip(dhw, stride)]
    return pools


def full_f32_precision() -> None:
    """Float32 convolutions and matmuls on the card in full float32, not
    TF32 (cuDNN's default for convolutions)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def without_logits(state_dict) -> dict:
    """An I3D checkpoint in the reference's key layout without its logits
    head (for Kinetics' classes), which feature extraction never uses."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith("logits.")}


def pad_same(x, kernel, stride):
    """``x`` ``[N, C, D, H, W]`` zero-padded as XLA's SAME padding pads
    it (as it is where that pads nothing)."""
    pads = same_pads(x.shape[2:], kernel, stride)
    return F.pad(x, pads) if any(pads) else x


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the channel
    axis of ``[N, C, D, H, W]``, under ``nn.BatchNorm3d``'s key names.

    Training normalizes by the batch statistics (in float32, or float64
    for a float64 input) and moves the
    running ones by ``0.99 old + 0.01 batch`` with the biased variance;
    evaluation uses the running statistics.  The output has the input's
    dtype."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            for t, v in ((self.weight, 1.0), (self.bias, 0.0),
                         (self.running_mean, 0.0), (self.running_var, 1.0)):
                t.fill_(v)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        shape = (1, -1, 1, 1, 1)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = (0, 2, 3, 4)
            mean = xf.mean(dims)
            var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class Unit3D(nn.Module):
    """Conv3d + BatchNorm + ReLU with TF-same padding."""

    def __init__(self, in_channels: int, features: int,
                 kernel=(1, 1, 1), stride=(1, 1, 1), *,
                 use_batch_norm: bool = True, use_bias: bool = False,
                 activation: bool = True, dtype: torch.dtype | None = None,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.activation = activation
        self.dtype = dtype
        self.act_dtype = act_dtype
        self.conv3d = nn.Conv3d(in_channels, features, self.kernel,
                                self.stride, bias=use_bias)
        self.bn = BatchNorm(features) if use_batch_norm else None

    def reset_parameters(self, generator=None) -> None:
        """flax's init: ``lecun_normal`` kernel, zero bias, BatchNorm
        scale 1, bias 0, mean 0, variance 1."""
        w = self.conv3d.weight
        lecun_normal_(w, w[0].numel(), generator)
        if self.conv3d.bias is not None:
            nn.init.zeros_(self.conv3d.bias)
        if self.bn is not None:
            self.bn.reset_parameters()

    def forward(self, x: torch.Tensor, *, train: bool = False):
        x = pad_same(x, self.kernel, self.stride)
        w, b = self.conv3d.weight, self.conv3d.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        else:
            x = x.to(w.dtype)
        x = F.conv3d(x, w, b, self.stride).to(self.act_dtype)
        if self.bn is not None:
            x = self.bn(x, train=train)
        return torch.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """4-branch Inception block: ``out_channels`` = [b0, b1a, b1b, b2a,
    b2b, b3b]."""

    def __init__(self, in_channels: int, out_channels, **kw):
        super().__init__()
        oc = out_channels
        self.b0 = Unit3D(in_channels, oc[0], **kw)
        self.b1a = Unit3D(in_channels, oc[1], **kw)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), **kw)
        self.b2a = Unit3D(in_channels, oc[3], **kw)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), **kw)
        self.b3b = Unit3D(in_channels, oc[5], **kw)
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x, *, train: bool = False):
        b0 = self.b0(x, train=train)
        b1 = self.b1b(self.b1a(x, train=train), train=train)
        b2 = self.b2b(self.b2a(x, train=train), train=train)
        b3 = self.b3b(max_pool3d_same(x, (3, 3, 3), (1, 1, 1)), train=train)
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionI3d(nn.Module):
    """The I3D backbone: clips -> ``[B, T, feature_dim]`` features (1024 at
    ``Mixed_5c``).

    ``num_classes`` sizes the logits head (``with_logits``), which the
    reference's checkpoints carry; ``None`` builds none (the pixels model,
    whose head is the LSTM).  ``final_endpoint`` cuts the chain, as in
    ``ctc_tpu``."""

    def __init__(self, num_classes: int | None = 400,
                 dropout_rate: float = 0.5,
                 final_endpoint: str = "Mixed_5c",
                 dtype: torch.dtype | None = None,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__()
        names = [n for n, _ in ENDPOINTS]
        if final_endpoint not in names:
            raise ValueError(f"unknown final_endpoint {final_endpoint!r}")
        self.final_endpoint = final_endpoint
        self.dropout_rate = dropout_rate
        self.pools = {}
        kw = dict(dtype=dtype, act_dtype=act_dtype)
        channels = 3
        for name, spec in ENDPOINTS[:names.index(final_endpoint) + 1]:
            if spec[0] == "unit":
                _, feats, kernel, stride = spec
                self.add_module(name, Unit3D(channels, feats, kernel, stride,
                                             **kw))
                channels = feats
            elif spec[0] == "pool":
                self.pools[name] = spec[1:]
            else:
                mod = InceptionModule(channels, spec[1], **kw)
                self.add_module(name, mod)
                channels = mod.out_channels
        self.feature_dim = channels
        self.logits = (None if num_classes is None else
                       Unit3D(channels, num_classes, use_batch_norm=False,
                              use_bias=True, activation=False))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, Unit3D):
                m.reset_parameters(generator)

    def forward(self, clips: torch.Tensor, *, train: bool = False,
                with_logits: bool = False,
                generator: torch.Generator | None = None):
        """``clips``: ``[B, T, stack, h, w, 3]`` (or ``[B, stack, h, w,
        3]``).  Returns ``[B, T, feature_dim]`` (``[B, feature_dim]``), or
        ``(logits, feats)`` with ``with_logits``."""
        single = clips.dim() == 5
        if single:
            clips = clips[:, None]
        b, t = clips.shape[:2]
        with span("ctc/models/i3d"):
            # [B*T, stack, h, w, 3] -> [N, C, D, H, W], channels_last_3d view
            x = clips.reshape((b * t,) + clips.shape[2:]).permute(
                0, 4, 1, 2, 3)
            for name, _ in ENDPOINTS:
                with span(f"ctc/models/i3d/{name}"):
                    if name in self.pools:
                        x = max_pool3d_same(x, *self.pools[name])
                    else:
                        x = getattr(self, name)(x, train=train)
                if name == self.final_endpoint:
                    break
            # avg_pool (2, 7, 7) stride 1 VALID, then the mean over (t, h,
            # w); summed in at least f32 (the CPU has no bf16 avg_pool3d),
            # in x's dtype
            with span("ctc/models/i3d/avg_pool"):
                pooled = F.avg_pool3d(
                    x.to(torch.promote_types(x.dtype, torch.float32)),
                    (2, 7, 7), stride=1).to(x.dtype)
                feats = pooled.mean((2, 3, 4)).reshape(b, t, -1)
        if single:
            feats = feats[:, 0]
        if not with_logits:
            return feats
        if self.logits is None:
            raise ValueError("with_logits needs a backbone built with "
                             "num_classes")
        logits_in = pooled.float()
        if train:
            logits_in = dropout(logits_in, self.dropout_rate, generator)
        logits = self.logits(logits_in, train=train)
        logits = logits.mean((2, 3, 4)).reshape(b, t, -1)
        if single:
            logits = logits[:, 0]
        return logits, feats
