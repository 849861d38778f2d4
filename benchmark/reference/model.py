"""The plain reference of the benchmark's model: Inception-v1 I3D and the
LSTM head, as functions of a dict of named tensors.

* I3D (Carreira & Zisserman, "Quo Vadis, Action Recognition?",
  arXiv:1705.07750): Inception-v1 inflated to 3-D at its published widths,
  TF-"same" padding (total ``max((ceil(n / s) - 1) s + k - n, 0)``, the
  smaller half in front), max pools padded with -inf, BatchNorm with eps
  1e-3 whose batch statistics are ``E[x^2] - E[x]^2`` clipped at 0 (the
  released model's flax rule), ReLU; then a (2, 7, 7) average pool of
  stride 1 and the mean over what is left, 1024 features a clip.  Names
  follow the released PyTorch I3D (``Mixed_3b.b1b.conv3d.weight``).
* The head: Linear -> BatchNorm over the batch at each time step (biased
  variance, eps 1e-5) -> ReLU -> inverted dropout -> an LSTM cell (gates i,
  f, g, o) whose input product for all steps is one matmul.
* The loss: log-softmax emissions of the verb path, the blank-free lattice
  ``alpha[t, l] = em[t, l] + logaddexp(alpha[t-1, l], alpha[t-1, l-1])``
  with cells past the path's length at -1e13 before the emission is added,
  and the batch mean of ``-alpha[T-1, L_b-1]``.

Plain ``torch`` operations only; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: (name, kind, spec) of the published I3D, in order
I3D = (
    ("Conv3d_1a_7x7", "unit", (64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "unit", (64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "unit", (192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", "mixed", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", "mixed", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", "mixed", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", "mixed", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", "mixed", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", "mixed", (384, 192, 384, 48, 128, 128)),
)
#: a Mixed block's branches: (name, input, out index, kernel)
BRANCHES = (("b0", None, 0, 1), ("b1a", None, 1, 1), ("b1b", "b1a", 2, 3),
            ("b2a", None, 3, 1), ("b2b", "b2a", 4, 3), ("b3b", "pool", 5, 1))
BN_EPS_I3D = 1e-3
BN_EPS_HEAD = 1e-5
NEG = -1.0e13


def i3d_units():
    """``(prefix, in channels, out channels, kernel, stride)`` of every
    conv unit, in order."""
    units, c = [], 3
    for name, kind, spec in I3D:
        if kind == "unit":
            out, k, s = spec
            units.append((name, c, out, k, s))
            c = out
        elif kind == "mixed":
            for b, src, idx, k in BRANCHES:
                cin = spec[1] if src == "b1a" else spec[3] if src == "b2a" \
                    else c
                units.append((f"{name}.{b}", cin, spec[idx], (k,) * 3,
                              (1, 1, 1)))
            c = spec[0] + spec[2] + spec[4] + spec[5]
    return units


def i3d_shapes() -> dict:
    """``{name: shape}`` of the I3D's parameters and BatchNorm statistics."""
    out = {}
    for prefix, cin, cout, k, _ in i3d_units():
        out[f"{prefix}.conv3d.weight"] = (cout, cin, *k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.bn.{leaf}"] = (cout,)
    return out


def head_shapes(in_features: int, hidden: int) -> dict:
    return {
        "feature_head.proj.weight": (hidden, in_features),
        "feature_head.proj.bias": (hidden,),
        "feature_head.bn.weight": (hidden,),
        "feature_head.bn.bias": (hidden,),
        "feature_head.bn.running_mean": (hidden,),
        "feature_head.bn.running_var": (hidden,),
        "input_gates.weight": (4 * hidden, hidden),
        "input_gates.bias": (4 * hidden,),
        "recurrent_kernel": (hidden, 4 * hidden),
    }


def _same(x, kernel, stride, value=0.0):
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel),
                       reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _unit(p, prefix, x, stride, train):
    w = p[f"{prefix}.conv3d.weight"]
    x = F.conv3d(_same(x, w.shape[2:], stride), w, None, stride)
    if train:
        dims = (0, 2, 3, 4)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean = p[f"{prefix}.bn.running_mean"]
        var = p[f"{prefix}.bn.running_var"]
    shape = (1, -1, 1, 1, 1)
    x = ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS_I3D)
         * p[f"{prefix}.bn.weight"].view(shape)
         + p[f"{prefix}.bn.bias"].view(shape))
    return torch.relu(x)


def _max_pool(x, kernel, stride):
    return F.max_pool3d(_same(x, kernel, stride, -math.inf), kernel, stride)


def i3d_features(p: dict, clips: torch.Tensor, *, train: bool):
    """``[N, stack, h, w, 3]`` clips -> ``[N, 1024]`` features; ``p`` maps
    the I3D's names (no prefix) to tensors."""
    x = clips.permute(0, 4, 1, 2, 3)
    for name, kind, spec in I3D:
        if kind == "unit":
            x = _unit(p, name, x, spec[2], train)
        elif kind == "pool":
            x = _max_pool(x, *spec)
        else:
            b0 = _unit(p, f"{name}.b0", x, (1, 1, 1), train)
            b1 = _unit(p, f"{name}.b1b",
                       _unit(p, f"{name}.b1a", x, (1, 1, 1), train),
                       (1, 1, 1), train)
            b2 = _unit(p, f"{name}.b2b",
                       _unit(p, f"{name}.b2a", x, (1, 1, 1), train),
                       (1, 1, 1), train)
            b3 = _unit(p, f"{name}.b3b", _max_pool(x, (3, 3, 3), (1, 1, 1)),
                       (1, 1, 1), train)
            x = torch.cat([b0, b1, b2, b3], dim=1)
    return F.avg_pool3d(x, (2, 7, 7), stride=1).mean((2, 3, 4))


def head_logits(p: dict, feats: torch.Tensor, mask: torch.Tensor,
                keep: float):
    """``[T, B, F]`` features -> ``[T, B, hidden]`` logits in training mode;
    ``mask`` is dropout's ``[T, B, hidden]`` draw (kept where > 0)."""
    x = feats @ p["feature_head.proj.weight"].T + p["feature_head.proj.bias"]
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    x = ((x - mean) / torch.sqrt(var + BN_EPS_HEAD)
         * p["feature_head.bn.weight"] + p["feature_head.bn.bias"])
    x = torch.relu(x)
    x = torch.where(mask > 0, x / keep, torch.zeros_like(x))
    xw = x @ p["input_gates.weight"].T + p["input_gates.bias"]
    hidden = p["recurrent_kernel"].shape[0]
    h = c = feats.new_zeros((feats.shape[1], hidden))
    out = []
    for t in range(feats.shape[0]):
        i, f, g, o = (xw[t] + h @ p["recurrent_kernel"]).split(hidden, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


def noblank_loss(logits, paths, lengths):
    """Batch mean of the blank-free lattice NLL; ``logits [T, B, C]``,
    ``paths [B, L]`` class indices (-1 padded), ``lengths [B]``."""
    steps, _, classes = logits.shape
    logp = torch.log_softmax(logits, dim=2)
    idx = torch.remainder(paths.long(), classes)
    em = torch.gather(logp, 2, idx[None].expand(steps, -1, -1))  # [T, B, L]
    width = em.shape[2]
    outside = (torch.arange(width, device=em.device)[None, :]
               >= lengths[:, None])
    neg = torch.full_like(em[0], NEG)
    alpha = neg.clone()
    alpha[:, 0] = 0.0
    for t in range(steps):
        advance = torch.cat([neg[:, :1], (alpha if t else neg)[:, :-1]], 1)
        alpha = torch.where(outside, neg,
                            torch.logaddexp(alpha, advance)) + em[t]
    final = alpha.gather(1, (lengths.long() - 1)[:, None])[:, 0]
    return -final.mean()
