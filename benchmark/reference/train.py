"""The reference's training steps, its initial weights, and the numbers
that the benchmark holds the program to, for any model: what is particular
to one (its leaves, how each starts, which optimizer moves it, its
forward to the loss) comes from the configuration's reference module
(:data:`benchmark.spec.MODEL_CONTRACT`), passed in as ``model``.

* :func:`initial_weights` draws the model's starting point from the seed on
  the device, in one call: normals scaled by ``1 / sqrt(fan_in)`` for every
  kernel, in the order of ``shapes``; ones and zeros where ``model.init``
  says so.  Both the program and :func:`train_steps` start from it.
* :func:`train_steps` runs the recipe's steps: ``model.loss`` (dropout's
  masks from a ``torch.Generator`` on the device seeded as the recipe seeds
  its own), L2 weight decay added to the gradient, then each trained leaf
  moved by its optimizer at the first epoch's learning rate: Adam (betas
  0.9 / 0.999, eps 1e-8, bias corrected) or SGD with momentum (no
  dampening).
* :func:`compare` reduces both sides to the numbers that decide
  ``correct``.
"""

from __future__ import annotations

import contextlib
import math

import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
#: leaves whose reference gradient is under this share of the median
#: leaf's move under Adam by round-off alone; their change is not compared
STILL_LEAF = 1e-3


def initial_weights(model, shapes: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for ``shapes`` (float32 on ``device``)."""
    kinds = {n: model.init(n, s) for n, s in shapes.items()}
    kernels = [n for n, (kind, _) in kinds.items() if kind == "kernel"]
    total = sum(math.prod(shapes[n]) for n in kernels)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, fan_in = kinds[name]
        if kind == "kernel":
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) / math.sqrt(fan_in)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: no initialisation {kind!r}")
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 convolutions and matmuls in full float32 (TF32 off), or in
    TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_steps(model, weights: dict, batches: list, *, finetune: bool,
                seed: int, lr: float, weight_decay: float, momentum: float,
                dropout: float, tf32: bool = False) -> dict:
    """Train ``len(batches)`` steps of ``model`` from ``weights``, in
    float32 with TF32 off (``tf32``: on, the control).  Returns each step's
    loss, the first step's gradient as the optimizer receives it (L2
    included), and the trained leaves after the last step."""
    with precision(tf32):
        return _train_steps(model, weights, batches, finetune=finetune,
                            seed=seed, lr=lr, weight_decay=weight_decay,
                            momentum=momentum, dropout=dropout)


def _train_steps(model, weights, batches, *, finetune, seed, lr,
                 weight_decay, momentum, dropout):
    moved_by = {n: model.optimizer(n, finetune) for n in weights}
    names = [n for n in weights if moved_by[n]]
    p = {k: v.detach().clone() for k, v in weights.items()}
    device = next(iter(p.values())).device
    adam = {n: [torch.zeros_like(p[n]), torch.zeros_like(p[n])]
            for n in names if moved_by[n] == "adam"}
    trace = {n: torch.zeros_like(p[n]) for n in names
             if moved_by[n] == "sgd"}
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = 1.0 - dropout
    b1, b2 = ADAM_BETAS
    losses, first = [], None
    for count, batch in enumerate(batches, start=1):
        leaves = {n: p[n].requires_grad_(True) for n in names}
        loss = model.loss(p, batch, finetune=finetune, keep=keep,
                          generator=gen)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.item())
        with torch.no_grad():
            g = {n: gr + weight_decay * p[n].detach()
                 for n, gr in zip(names, grads)}
            if first is None:
                first = {n: v.clone() for n, v in g.items()}
            new = {}
            for n in names:
                w = p[n].detach()
                if n in adam:
                    m, v = adam[n]
                    m.mul_(b1).add_(g[n], alpha=1 - b1)
                    v.mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                    step = (m / (1 - b1 ** count)) / (
                        torch.sqrt(v / (1 - b2 ** count)) + ADAM_EPS)
                    new[n] = w - lr * step
                else:
                    trace[n] = g[n] + momentum * trace[n]
                    new[n] = w - lr * trace[n]
            p.update(new)
    return {"losses": losses, "grad1": first,
            "params": {n: p[n].detach() for n in names}}


def _leaf_gaps(prog: dict, refs: dict, names) -> dict:
    """Each leaf's gap between the two sides' norms, over the larger of
    that leaf's and the median leaf's reference norm."""
    norms = {n: float(torch.linalg.vector_norm(refs[n].double()))
             for n in names}
    median = sorted(norms.values())[len(norms) // 2]
    return {n: abs(float(torch.linalg.vector_norm(prog[n].double()))
                   - norms[n]) / max(norms[n], median, 1e-30)
            for n in names}


def _summary(gaps: dict, key: str) -> dict:
    """The worst leaf's gap, its name, and the median leaf's gap."""
    worst = max(gaps, key=gaps.get)
    return {f"{key}_gap": gaps[worst], f"{key}_leaf": worst,
            f"{key}_gap_median": sorted(gaps.values())[len(gaps) // 2]}


def compare(program: dict, reference: dict, initial: dict) -> dict:
    """The numbers that decide ``correct``: each step loss's relative gap
    (the worst, and the first step's); the first gradient's norms, leaf by
    leaf; and the norms of each leaf's change over the steps, leaves whose
    reference gradient is still (``STILL_LEAF``) left out.  A leaf's gap
    is read against the larger of its own and the median leaf's reference
    norm; the worst leaf's and the median leaf's gaps are both given.
    Each side is a dict of :func:`train_steps`' form; tensors may sit on
    any device."""
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(program["losses"], reference["losses"])]
    names = list(reference["grad1"])
    g_ref = {n: reference["grad1"][n].double().cpu() for n in names}
    out = {"loss_gap": max(steps), "loss_gap_first": steps[0],
           **_summary(_leaf_gaps(
               {n: program["grad1"][n].cpu() for n in names}, g_ref, names),
               "grad")}
    g_norm = {n: float(torch.linalg.vector_norm(g_ref[n])) for n in names}
    median = sorted(g_norm.values())[len(g_norm) // 2]
    moving = [n for n in names if g_norm[n] >= STILL_LEAF * median]
    change = {side: {n: d["params"][n].double().cpu()
                     - initial[n].double().cpu() for n in moving}
              for side, d in (("program", program), ("reference", reference))}
    out.update(_summary(_leaf_gaps(change["program"], change["reference"],
                                   moving), "change"))
    out["still_leaves"] = sorted(set(names) - set(moving))
    return out
