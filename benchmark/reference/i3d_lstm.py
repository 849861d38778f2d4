"""The reference of configuration ``i3d-lstm-charades``: Inception-v1 I3D on
each step's clip of frames, then the LSTM head and the blank-free loss of
:mod:`benchmark.reference.lstm_head`, as functions of a dict of named
tensors, and this model's side of the contract that
:data:`benchmark.spec.MODEL_CONTRACT` lists.

* I3D (Carreira & Zisserman, "Quo Vadis, Action Recognition?",
  arXiv:1705.07750): Inception-v1 inflated to 3-D at its published widths,
  TF-"same" padding (total ``max((ceil(n / s) - 1) s + k - n, 0)``, the
  smaller half in front), max pools padded with -inf, BatchNorm with eps
  1e-3 whose batch statistics are ``E[x^2] - E[x]^2`` clipped at 0 (the
  released model's flax rule), ReLU; then a (2, 7, 7) average pool of
  stride 1 and the mean over what is left, 1024 features a clip.  Names
  follow the released PyTorch I3D (``Mixed_3b.b1b.conv3d.weight``) under
  ``i3d.``; the program's names are the same.
* A clip is ``stack`` frames ``gap + 1`` apart from the step's anchor.
* Frozen, the backbone runs in inference mode without a gradient, in
  blocks of ``BLOCK`` clips; finetuned, in training mode, its convolutions
  and BatchNorm scales and shifts moved by SGD with momentum.  The head is
  Adam's either way.
* :func:`i3d_flops`: the I3D's convolutions (2 per multiply-add, the zero
  padding included), max and average pools (one per window element) and
  BatchNorm (2 per element for the scale and shift, 3 more for the batch
  statistics in training mode).  Frozen: the forward alone.  Finetuned:
  the forward, each convolution's weight gradient and input gradient
  except the first's (its input is the frames), twice the forward's
  BatchNorm and one operation per pool input.

Plain ``torch`` operations only; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import lstm_head

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
PREFIX = "i3d."
#: clips a block of the frozen backbone's forward
BLOCK = 20
#: the attribute of the program's model whose forward the benchmark times
TIMED = "i3d"


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


def shapes(conf: dict) -> dict:
    """``{reference name: shape}`` of the leaves and buffers, in the order
    of the initial weights' draw: the head's, then the I3D's."""
    out = lstm_head.shapes(conf)
    out.update({PREFIX + k: v for k, v in i3d_shapes().items()})
    return out


def init(name: str, shape) -> tuple:
    """As :func:`lstm_head.init` for the head; for the I3D, each
    convolution a kernel over ``in channels x kernel volume``, BatchNorm's
    scale and running variance ones, the rest zeros."""
    if name.startswith(lstm_head.PREFIX):
        return lstm_head.init(name, shape)
    if name.endswith("conv3d.weight"):
        return "kernel", math.prod(shape[1:])
    if name.endswith(("bn.weight", "running_var")):
        return "ones", None
    return "zeros", None


def optimizer(name: str, finetune: bool):
    """The head's leaves: Adam; the I3D's: SGD where ``finetune``, else
    none; running statistics: none."""
    if not name.startswith(PREFIX):
        return lstm_head.optimizer(name, finetune)
    return "sgd" if finetune and "running_" not in name else None


def ref_name(name: str) -> str:
    """The program's names are the reference's."""
    return name


def clip_offsets(conf: dict) -> list:
    """Frame offsets from a step's anchor: ``stack`` frames ``gap + 1``
    apart."""
    step = conf["geometry"]["gap"] + 1
    return [step * i for i in range(conf["stack"])]


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


def loss(p: dict, batch: dict, *, finetune: bool, keep: float,
         generator: torch.Generator):
    """The scalar training loss of ``batch`` (``feats [B, T, stack, h, w,
    3]`` clips, ``paths``, ``target_lengths``) under the leaves ``p``."""
    feats = batch["feats"]
    b, t = feats.shape[:2]
    clips = feats.reshape((b * t,) + feats.shape[2:])
    i3d = lstm_head.sub(p, PREFIX)
    if finetune:
        out = i3d_features(i3d, clips, train=True)
    else:
        with torch.no_grad():
            out = torch.cat([i3d_features(i3d, c, train=False)
                             for c in clips.split(BLOCK)])
    return lstm_head.head_loss(p, out.reshape(b, t, -1).transpose(0, 1),
                               batch, keep=keep, generator=generator)


def _out(size, kernel, stride):
    return tuple(math.ceil(n / s) for n, s in zip(size, stride))


def i3d_flops(clips: int, *, frames: int = 10, size: int = 224,
              finetune: bool = False) -> float:
    """Model FLOPs of the I3D over ``clips`` clips of ``frames`` x ``size``
    x ``size``."""
    parts = i3d_parts(clips, frames=frames, size=size, finetune=finetune)
    if not finetune:
        return parts["conv"] + parts["pool"] + parts["bn"]
    return (2 * parts["conv"] + parts["conv_dgrad"] + parts["pool"]
            + parts["pool_inputs"] + 3 * parts["bn"])


def i3d_parts(clips: int, *, frames: int = 10, size: int = 224,
              finetune: bool = False) -> dict:
    """The I3D's forward FLOPs by kind: ``conv`` (2 a multiply-add),
    ``conv_dgrad`` (the convolutions that take an input gradient), ``pool``
    (a window element each), ``bn``, and ``pool_inputs`` (the elements the
    pools read)."""
    conv = conv_dgrad = pool = bn = 0.0
    first = True
    shape, c = (frames, size, size), 3

    def unit(shape, cin, cout, kernel, stride):
        nonlocal conv, conv_dgrad, bn, first
        out = _out(shape, kernel, stride)
        elems = clips * cout * math.prod(out)
        macs = elems * cin * math.prod(kernel)
        conv += 2 * macs
        if not first:
            conv_dgrad += 2 * macs
        first = False
        bn += elems * (5 if finetune else 2)
        return out

    def max_pool(shape, ch, kernel, stride):
        nonlocal pool
        out = _out(shape, kernel, stride)
        pool += clips * ch * math.prod(out) * math.prod(kernel)
        pool_in = clips * ch * math.prod(shape)
        return out, pool_in

    pool_inputs = 0.0
    for _, kind, spec in I3D:
        if kind == "unit":
            cout, kernel, stride = spec
            shape, c = unit(shape, c, cout, kernel, stride), cout
        elif kind == "pool":
            shape, n = max_pool(shape, c, *spec)
            pool_inputs += n
        else:
            widths = {"b1a": spec[1], "b2a": spec[3]}
            for name, src, idx, k in BRANCHES:
                cin = widths.get(src, c)
                if src == "pool":
                    _, n = max_pool(shape, c, (3, 3, 3), (1, 1, 1))
                    pool_inputs += n
                unit(shape, cin, spec[idx], (k,) * 3, (1, 1, 1))
            c = spec[0] + spec[2] + spec[4] + spec[5]
    # the (2, 7, 7) average pool of stride 1, then the mean over the rest
    avg = (shape[0] - 1, shape[1] - 6, shape[2] - 6)
    pool += clips * c * (math.prod(avg) * 2 * 7 * 7 + math.prod(avg))
    return {"conv": conv, "conv_dgrad": conv_dgrad, "pool": pool, "bn": bn,
            "pool_inputs": pool_inputs}


def step_flops(cell: dict) -> float:
    """Model FLOPs of one train step of ``cell``: the head's (with the
    projection's input gradient where the backbone trains) and the I3D's
    over the step's ``B x T`` clips."""
    conf = cell["config"]
    rows = cell["batch_size"] * conf["geometry"]["temporal"]
    return (lstm_head.head_flops(rows, conf["feature_dim"], conf["hidden"],
                                 input_grad=cell["finetune"])
            + i3d_flops(rows, frames=conf["stack"], size=conf["inputsize"],
                        finetune=cell["finetune"]))
