"""LSTM head over I3D clip features (port of ``ctc_tpu/models/lstm.py``).

* The feature projection, BatchNorm, ReLU and Dropout run over all
  timesteps at once; BatchNorm keeps per-timestep batch statistics.
* The recurrence is a fused-gate LSTM cell whose input-to-gates product for
  all T is one matmul; gate order is i, f, g, o (torch.nn.LSTMCell).
* Parameters start as flax's do: ``lecun_normal`` kernels, zero biases.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled so the variance is ``1 / fan_in``."""
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return torch.where(mask > 0, x / keep, 0.0)


class TemporalBatchNorm(nn.Module):
    """BatchNorm over the batch axis of ``[T, B, F]``, per timestep.

    Training normalizes each (t, f) slice by that timestep's batch
    statistics (biased variance, eps 1e-5); evaluation uses running
    statistics shared across timesteps.  The running statistics are updated
    once per call with the mean over T of the per-t statistics, the variance
    made unbiased by B / (B - 1), momentum 0.1 — the JAX package's rule, not
    ``nn.BatchNorm1d``'s.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=1, keepdim=True)  # [T, 1, F]
            var = (x - mean).square().mean(dim=1, keepdim=True)
            with torch.no_grad():
                batch = float(x.shape[1])
                unbiased = var * (batch / max(batch - 1.0, 1.0))
                m = self.momentum
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean.mean(dim=(0, 1))
                )
                self.running_var.copy_(
                    (1 - m) * self.running_var + m * unbiased.mean(dim=(0, 1))
                )
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.weight + self.bias


class FeatureHead(nn.Module):
    """Linear -> TemporalBatchNorm -> ReLU -> Dropout over ``[T, B, in]``."""

    def __init__(self, in_features: int, features: int,
                 dropout_rate: float = 0.3):
        super().__init__()
        self.proj = nn.Linear(in_features, features)
        self.bn = TemporalBatchNorm(features)
        self.dropout_rate = dropout_rate

    def forward(self, x, *, train: bool, generator=None):
        x = torch.relu(self.bn(self.proj(x), train=train))
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return x


class LSTMHead(nn.Module):
    """FeatureHead + fused-gate LSTM.

    Input ``[T, B, in_features]`` clip features; output ``[T, B, hidden]``
    hidden states (the per-class logits the losses read).
    """

    def __init__(self, in_features: int, hidden: int,
                 dropout_rate: float = 0.3):
        super().__init__()
        self.hidden = hidden
        self.feature_head = FeatureHead(in_features, hidden, dropout_rate)
        self.input_gates = nn.Linear(hidden, 4 * hidden)
        # [hidden, 4 * hidden], the orientation of h @ w_h
        self.recurrent_kernel = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax initialization: lecun_normal kernels, zero biases."""
        for lin in (self.feature_head.proj, self.input_gates):
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        lecun_normal_(self.recurrent_kernel, self.hidden, generator)

    def forward(self, feats, h0=None, c0=None, *, train: bool = False,
                generator: torch.Generator | None = None):
        _, batch, _ = feats.shape
        v = self.feature_head(feats, train=train, generator=generator)
        xw = self.input_gates(v)  # [T, B, 4H], one matmul for all T
        zeros = feats.new_zeros((batch, self.hidden))
        h = zeros if h0 is None else h0
        c = zeros if c0 is None else c0
        hs = []
        for xw_t in xw:
            gates = xw_t + h @ self.recurrent_kernel
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs)  # [T, B, H]
