"""The gated temporal-energy-graph (ST-graph) model and its mean-field CTC
criterion (port of ``ctc_tpu/models/stgraph.py``).

* :class:`STGraphBase`: scene / object / verb unary heads and 12 low-rank
  pairwise compatibility matrices (spatial so / ov / vs; temporal ss / oo /
  vv and the 6 cross pairs), each head computed for all timesteps at once.
* :class:`STGraphCriterion`: ``msg_n`` rounds of mean-field message passing
  over the s / o / v marginals (iteration n reads the heads' timestep n;
  log-softmax for the scene, log-sigmoid for the multi-label heads), then
  three blank-CTC losses on the output sequences, whose lattice runs on the
  CUDA kernels for CUDA tensors (:func:`ctc_tpu_torch.losses.blank.ctc_loss`),
  and optional ``winsmooth`` temporal smoothing.
* :class:`MessageStore`: the cross-batch per-video message queue with a
  Gaussian time kernel and compounding decay, host-side numpy.

Parameters start as flax's do (``lecun_normal`` kernels, zero biases);
:func:`ctc_tpu_torch.models.convert.stgraph_from_jax` carries ``ctc_tpu``'s.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctc_tpu_torch.losses.blank import ctc_loss
from ctc_tpu_torch.models.lstm import dropout, lecun_normal_


#: the hidden width of the scene branch and of every pair head's MLPs, which
#: ``ctc_tpu`` fixes
HIDDEN = 1000


class _PairHead(nn.Module):
    """Low-rank pairwise energy: ``feat [T, B, D]`` -> ``[T, B, rows, rank]
    x [T, B, rank, cols]`` -> ``[T, B, rows, cols]``; each factor is an MLP
    (Linear, ReLU, dropout, Linear)."""

    def __init__(self, in_features: int, rows: int, cols: int, rank: int,
                 dropout_rate: float = 0.3):
        super().__init__()
        self.rows, self.cols, self.rank = rows, cols, rank
        self.dropout_rate = dropout_rate
        self.a_h = nn.Linear(in_features, HIDDEN)
        self.a_o = nn.Linear(HIDDEN, rows * rank)
        self.b_h = nn.Linear(in_features, HIDDEN)
        self.b_o = nn.Linear(HIDDEN, rank * cols)

    def _mlp(self, feat, hid, out, train, generator):
        x = torch.relu(hid(feat))
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return out(x)

    def forward(self, feat, *, train: bool = False, generator=None):
        lead = feat.shape[:-1]
        a = self._mlp(feat, self.a_h, self.a_o, train, generator).reshape(
            lead + (self.rows, self.rank))
        b = self._mlp(feat, self.b_h, self.b_o, train, generator).reshape(
            lead + (self.rank, self.cols))
        return torch.matmul(a, b)


_PAIRS = (
    ("so", "s", "o"), ("ov", "o", "v"), ("vs", "v", "s"),       # spatial
    ("ss", "s", "s"), ("oo", "o", "o"), ("vv", "v", "v"),       # temporal
    ("so_t", "s", "o"), ("ov_t", "o", "v"), ("vs_t", "v", "s"),
    ("os_t", "o", "s"), ("vo_t", "v", "o"), ("sv_t", "s", "v"),
)


class STGraphBase(nn.Module):
    """Unary s / o / v heads and the 12 pairwise compatibility tensors over
    ``[T, B, in_features]`` features."""

    def __init__(self, in_features: int, s_classes: int = 16,
                 o_classes: int = 38, v_classes: int = 33,
                 num_low_rank: int = 5, dropout_rate: float = 0.3):
        super().__init__()
        self.dropout_rate = dropout_rate
        sizes = {"s": s_classes, "o": o_classes, "v": v_classes}
        self.s_h1 = nn.Linear(in_features, HIDDEN)
        self.s_h2 = nn.Linear(HIDDEN, HIDDEN)
        self.s_out = nn.Linear(HIDDEN, s_classes)
        self.o = nn.Linear(in_features, o_classes)
        self.v = nn.Linear(in_features, v_classes)
        self.pairs = nn.ModuleDict({
            name: _PairHead(in_features, sizes[left], sizes[right],
                            num_low_rank, dropout_rate=dropout_rate)
            for name, left, right in _PAIRS})
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax initialization: lecun_normal kernels, zero biases."""
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                lecun_normal_(lin.weight, lin.in_features, generator)
                nn.init.zeros_(lin.bias)

    def forward(self, feat, *, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """``feat [T, B, D]`` -> dict of unary ``[T, B, C]`` and pairwise
        ``[T, B, A, B']`` energies; dropout (rate ``dropout_rate``, masks
        from ``generator``) only with ``train``."""
        s = feat
        for lin in (self.s_h1, self.s_h2):
            s = torch.relu(lin(s))
            if train:
                s = dropout(s, self.dropout_rate, generator)
        out = {"s": self.s_out(s), "o": self.o(feat), "v": self.v(feat)}
        for name, _, _ in _PAIRS:
            out[name] = self.pairs[name](feat, train=train,
                                         generator=generator)
        return out


def winsmooth(mat: torch.Tensor, kernelsize: int = 1) -> torch.Tensor:
    """Windowed temporal mean over axis 0:
    ``out[m] = mean(mat[max(0, m-k) : min(n-1, m+k) + 1])``."""
    n = mat.shape[0]
    idx = torch.arange(n, device=mat.device)
    lo = torch.clamp(idx - kernelsize, min=0)
    hi = torch.clamp(idx + kernelsize, max=n - 1)
    csum = torch.cumsum(torch.cat([torch.zeros_like(mat[:1]), mat]), dim=0)
    count = (hi - lo + 1).to(mat.dtype)
    sel = csum[hi + 1] - csum[lo]
    return sel / count.reshape((n,) + (1,) * (mat.ndim - 1))


def gtmat(sizes: Sequence[int], target: torch.Tensor) -> torch.Tensor:
    """Int targets ``[N]`` -> float32 one-hot rows ``[N, sizes[1]]``,
    broadcast to ``sizes`` when it has three entries.  A label outside
    ``[0, sizes[1])``, negative ones included, gives a zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    classes = torch.arange(sizes[1], device=target.device)
    out = (target[..., None] == classes).float()
    if len(sizes) == 3:
        out = out[:, :, None].expand(tuple(sizes))
    return out


def mean_field_messages(heads: dict, *, msg_n: int, w_temporal: float = 1.0,
                        w_spatio: float = 1.0, s_msg0=None, o_msg0=None,
                        v_msg0=None):
    """The synchronous mean-field loop.

    Iteration n reads timestep n of every head; messages carry the previous
    iteration's log-marginals and start at zero.  ``s_msg0``, ``o_msg0``
    and ``v_msg0`` are accepted and change nothing: ``ctc_tpu`` overwrites
    them with zeros at the first iteration.  Returns the ``[msg_n, B, C]``
    output label sequences (log-space) for s, o, v.
    """
    del s_msg0, o_msg0, v_msg0
    s, o, v = heads["s"], heads["o"], heads["v"]

    def row(msg, mat):  # bmm(msg[B,1,A], mat[B,A,C]) -> [B,C]
        return torch.einsum("ba,bac->bc", msg, mat)

    def col(mat, msg):  # bmm(mat[B,A,C], msg[B,C,1]) -> [B,A]
        return torch.einsum("bac,bc->ba", mat, msg)

    s_out, o_out, v_out = [], [], []
    for n in range(msg_n):
        _qs = F.log_softmax(s[n], dim=1)
        _qo = F.logsigmoid(o[n])
        _qv = F.logsigmoid(v[n])
        if n == 0:
            s_msg = torch.zeros_like(_qs)
            o_msg = torch.zeros_like(_qo)
            v_msg = torch.zeros_like(_qv)
        qs_pre = (
            s[n]
            + row(s_msg, heads["ss"][n]) * w_temporal
            + row(o_msg, heads["os_t"][n]) * w_temporal
            + row(v_msg, heads["vs_t"][n]) * w_temporal
            + col(heads["so"][n], _qo) * w_spatio
            + row(_qv, heads["vs"][n]) * w_spatio
        )
        qo_pre = (
            o[n]
            + row(o_msg, heads["oo"][n]) * w_temporal
            + row(v_msg, heads["vo_t"][n]) * w_temporal
            + row(s_msg, heads["so_t"][n]) * w_temporal
            + row(_qs, heads["so"][n]) * w_spatio
            + col(heads["ov"][n], _qv) * w_spatio
        )
        qv_pre = (
            v[n]
            + row(v_msg, heads["vv"][n]) * w_temporal
            + row(s_msg, heads["sv_t"][n]) * w_temporal
            + row(o_msg, heads["ov_t"][n]) * w_temporal
            + col(heads["vs"][n], _qs) * w_spatio
            + row(_qo, heads["ov"][n]) * w_spatio
        )
        s_msg = F.log_softmax(qs_pre, dim=1)
        o_msg = F.logsigmoid(qo_pre)
        v_msg = F.logsigmoid(qv_pre)
        s_out.append(s_msg)
        o_out.append(o_msg)
        v_out.append(v_msg)
    return torch.stack(s_out), torch.stack(o_out), torch.stack(v_out)


class STGraphCriterion:
    """Mean-field message passing and blank-CTC losses on the s / o / v
    sequences.

    The three losses are ``ctc_loss(..., normalize=False)`` (mean over the
    batch of each NLL over its target length) on the log-space sequences as
    they are: the o and v sequences are log-sigmoid scores, not normalized
    over their classes, and the lattice takes them so.  A target too long
    for ``msg_n`` frames gives the sentinel-scale loss (~1e30)."""

    def __init__(self, *, msg_n: int, w_temporal: float = 1.0,
                 w_spatio: float = 1.0, smooth_kernel: int = 1):
        self.msg_n = msg_n
        self.w_temporal = w_temporal
        self.w_spatio = w_spatio
        self.smooth_kernel = smooth_kernel

    def __call__(self, heads: dict, s_target, o_target, v_target,
                 target_lengths, *, synchronous: bool = False):
        """``s_target [B]`` int, ``o_target`` / ``v_target [B, L]`` int
        label sequences, ``target_lengths [B]`` -> ``(s_seq, o_seq, v_seq,
        loss)``; with ``synchronous`` the sequences are returned smoothed
        (``winsmooth``, after the loss)."""
        s_seq, o_seq, v_seq = mean_field_messages(
            heads, msg_n=self.msg_n, w_temporal=self.w_temporal,
            w_spatio=self.w_spatio)
        batch, device = s_seq.shape[1], s_seq.device
        in_len = torch.full((batch,), self.msg_n, dtype=torch.int32,
                            device=device)
        ones = torch.ones((batch,), dtype=torch.int32, device=device)
        loss = (
            ctc_loss(s_seq, s_target[:, None], in_len, ones, normalize=False)
            + ctc_loss(o_seq, o_target, in_len, target_lengths,
                       normalize=False)
            + ctc_loss(v_seq, v_target, in_len, target_lengths,
                       normalize=False)
        )
        if synchronous:
            s_seq = winsmooth(s_seq, self.smooth_kernel)
            o_seq = winsmooth(o_seq, self.smooth_kernel)
            v_seq = winsmooth(v_seq, self.smooth_kernel)
        return s_seq, o_seq, v_seq, loss


class MessageStore:
    """Cross-batch per-video message memory (host-side numpy).

    ``set(ids, times, msgs)`` appends to a queue per video id, bounded at
    ``maxsize`` (the oldest entry goes); ``get(ids, times, size,
    direction)`` returns, per query, the decay-compounded Gaussian time
    kernel average of the stored messages strictly before (``'past'``) or
    after (``'future'``) the query time, zeros where there are none.
    """

    def __init__(self, maxsize: int = 20, decay: float = 1.0,
                 sigma: float = 300.0):
        self.maxsize = maxsize
        self.decay = decay
        self.sigma = sigma
        self._store: dict = {}

    def set(self, ids, times, msgs):
        for vid, t, m in zip(ids, times, msgs):
            q = self._store.setdefault(vid, [])
            q.append((float(t), np.asarray(m)))
            if len(q) > self.maxsize:
                del q[0]

    def get(self, ids, times, size, direction: str = "past") -> np.ndarray:
        out = []
        for vid, t0 in zip(ids, times):
            entries = [
                (t, m)
                for t, m in self._store.get(vid, [])
                if (t < t0 if direction == "past" else t > t0)
            ]
            if not entries:
                out.append(np.zeros(size, np.float32))
                continue
            total = np.zeros(size, np.float32)
            norm = 0.0
            for i, (t, m) in enumerate(entries):
                w_decay = 1.0 if i == 0 else (1.0 / self.decay) ** i
                w_kernel = math.exp(-((t - t0) ** 2) / (2 * self.sigma**2))
                total += m * w_decay * w_kernel
                norm += w_decay
            out.append(total / max(norm, 1e-12))
        return np.stack(out)
