"""The reference of configuration ``lstm-head-charades``: the LSTM head and
the blank-free loss on cached features, as functions of a dict of named
tensors, and this model's side of the contract that
:data:`benchmark.spec.MODEL_CONTRACT` lists.

* The head: Linear -> BatchNorm over the batch at each time step (biased
  variance, eps 1e-5) -> ReLU -> inverted dropout -> an LSTM cell (gates i,
  f, g, o) whose input product for all steps is one matmul.
* The loss: log-softmax emissions of the verb path, the blank-free lattice
  ``alpha[t, l] = em[t, l] + logaddexp(alpha[t-1, l], alpha[t-1, l-1])``
  with cells past the path's length at -1e13 before the emission is added,
  and the batch mean of ``-alpha[T-1, L_b-1]``.
* Leaves are named ``head.<program name>``; every one is trained with Adam.

Models with a backbone in front of the head call :func:`head_loss` on the
backbone's features.  Plain ``torch`` operations only; nothing of the
program is imported.
"""

from __future__ import annotations

import math

import torch

BN_EPS_HEAD = 1e-5
NEG = -1.0e13
PREFIX = "head."
#: the attribute of the program's model whose forward the benchmark times
TIMED = None


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


def shapes(conf: dict) -> dict:
    """``{reference name: shape}`` of the leaves and buffers, in the order
    of the initial weights' draw."""
    return {PREFIX + k: v for k, v in head_shapes(
        conf["feature_dim"], conf["hidden"]).items()}


def init(name: str, shape) -> tuple:
    """``("kernel", fan_in)``: normals over ``sqrt(fan_in)``; ``("ones",
    None)``: BatchNorm's scale and running variance; ``("zeros", None)``:
    biases and the running mean."""
    if name.endswith("recurrent_kernel"):
        return "kernel", shape[0]
    if len(shape) > 1:
        return "kernel", math.prod(shape[1:])
    if name.endswith(("bn.weight", "running_var")):
        return "ones", None
    return "zeros", None


def optimizer(name: str, finetune: bool):
    """``"adam"`` for every head parameter; None for BatchNorm's running
    statistics."""
    return None if "running_" in name else "adam"


def ref_name(name: str) -> str:
    """The reference name of the program's state-dict entry ``name``."""
    return PREFIX + name


def clip_offsets(conf: dict):
    """None: a step's inputs are cached features, not frames."""
    return None


def sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


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


def head_loss(p: dict, feats: torch.Tensor, batch: dict, *, keep: float,
              generator: torch.Generator):
    """The noblank loss of the head over ``[T, B, F]`` features, dropout's
    mask drawn from ``generator``."""
    t, b = feats.shape[:2]
    head = sub(p, PREFIX)
    mask = torch.empty((t, b, head["recurrent_kernel"].shape[0]),
                       device=feats.device).bernoulli_(keep,
                                                       generator=generator)
    logits = head_logits(head, feats, mask, keep)
    return noblank_loss(logits, batch["paths"], batch["target_lengths"])


def loss(p: dict, batch: dict, *, finetune: bool, keep: float,
         generator: torch.Generator):
    """The scalar training loss of ``batch`` (``feats [B, T, F]``,
    ``paths``, ``target_lengths``) under the leaves ``p``."""
    return head_loss(p, batch["feats"].transpose(0, 1), batch, keep=keep,
                     generator=generator)


def head_flops(rows: int, in_features: int, hidden: int, *,
               input_grad: bool = False) -> float:
    """Model FLOPs of one train step of the LSTM head over ``rows`` = T x
    B feature rows: its three matrix products per step and its BatchNorm,
    forward and backward; the feature projection's input gradient only
    where ``input_grad`` (a backbone in front of it trains)."""
    proj = 2 * rows * in_features * hidden
    gates = 2 * rows * hidden * 4 * hidden
    recurrent = 2 * rows * hidden * 4 * hidden
    bn = 5 * rows * hidden
    forward = proj + gates + recurrent + bn
    backward = (proj * (2 if input_grad else 1) + 2 * gates
                + 2 * recurrent + 2 * bn)
    return forward + backward


def step_flops(cell: dict) -> float:
    """Model FLOPs of one train step of ``cell``."""
    conf = cell["config"]
    rows = cell["batch_size"] * conf["geometry"]["temporal"]
    return head_flops(rows, conf["feature_dim"], conf["hidden"])
