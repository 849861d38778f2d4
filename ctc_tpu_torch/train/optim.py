"""The optimizer chain of ``ctc_tpu/train/trainer.py:395-518`` with every
count on the device.

``ctc_tpu`` composes optax transforms::

    MultiSteps(skip_nonfinite_updates(chain(log_grad_norms,
        multi_transform({"head": torch_style_adam,
                         "i3d": torch_style_sgd or set_to_zero}))))

(without a backbone, the head's Adam alone: ``add_decayed_weights,
scale_by_adam, scale_by_learning_rate``).

:class:`TorchStyleAdam` does the same arithmetic over tensors that live on
the parameters' device and are updated in place, so that their addresses
never change and a captured CUDA graph can hold them:

* Adam's moments ``exp_avg`` / ``exp_avg_sq``;
* ``count``: the optimizer updates so far, which drive Adam's bias
  correction and the learning-rate schedule (optax keeps one count in
  each; they move together); a skipped update does not move it;
* ``skipped``: updates dropped by ``skip_nonfinite``;
* under ``--finetune-i3d``, the backbone's SGD momentum trace
  (:class:`TorchStyleSGD`, a group the Adam chain carries); a frozen
  backbone's parameters are in no group and have no state.

Gradients accumulate in each parameter's ``.grad``, allocated once here
and never set to None.  Whether a batch ends an accumulation comes from
the batch count (the train state's ``step``), so nothing is decided on the
host.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.train.guards import log_grad_norms, skip_nonfinite_updates


class TorchStyleSGD:
    """``torch.optim.SGD(lr, momentum, weight_decay)`` as ``ctc_tpu``'s
    ``torch_style_sgd``: L2 added to the raw gradient, a momentum trace
    without dampening (``optax.trace``: ``t = g + momentum t``), then
    ``-lr t`` with ``lr = schedule(count)``, the count before the update.

    A group of :class:`TorchStyleAdam`'s chain, which moves its count and
    applies the guards to both groups alike."""

    def __init__(self, params, schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        with torch.no_grad():
            self.trace = ([torch.zeros_like(p) for p in self.params]
                          if momentum else [])
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    def candidates(self, count):
        """``(updates, new trace)`` for the gradients in ``.grad``."""
        grads = [p.grad for p in self.params]
        g = (torch._foreach_add(grads, self.params, alpha=self.weight_decay)
             if self.weight_decay else grads)
        if self.momentum:
            g = torch._foreach_add(g, torch._foreach_mul(self.trace,
                                                         self.momentum))
        return torch._foreach_mul(g, -self.schedule(count)), (
            g if self.momentum else [])


#: ``ctc_tpu``'s name: ``torch_style_sgd(params, schedule, momentum,
#: weight_decay)``
torch_style_sgd = TorchStyleSGD


class TorchStyleAdam:
    """``torch.optim.Adam(lr, weight_decay)``: L2 added to the raw gradient,
    then Adam, then ``-lr`` with ``lr`` read from the schedule at the count
    before the update.

    ``accum_grad`` k > 1 sums the gradients of k batches and steps on the
    k-th (``optax.MultiSteps(use_grad_mean=False)``); ``skip_nonfinite``
    drops an update whose summed gradient is not finite and keeps the
    parameters and every count; ``grad_norm_freq`` n > 0 reports the
    global norm of the summed gradient at each batch whose count is a
    multiple of n.  ``sgd`` (a :class:`TorchStyleSGD`) is a second group
    of parameters, the backbone's under ``--finetune-i3d``: the guards,
    the accumulation and the count cover both groups, as ``ctc_tpu``
    keeps ``log_grad_norms`` and ``skip_nonfinite`` outside its
    ``multi_transform``.
    """

    def __init__(self, params, weight_decay: float = 0.0, *,
                 accum_grad: int = 1, skip_nonfinite: bool = False,
                 grad_norm_freq: int = 0, betas=(0.9, 0.999),
                 eps: float = 1e-8, sgd: TorchStyleSGD | None = None):
        self.params = list(params)
        self.sgd = sgd
        self.weight_decay = weight_decay
        self.accum_grad = max(int(accum_grad), 1)
        self.skip_nonfinite = skip_nonfinite
        self.grad_norm_freq = grad_norm_freq
        self.betas = betas
        self.eps = eps
        device = self.params[0].device
        with torch.no_grad():
            self.exp_avg = [torch.zeros_like(p) for p in self.params]
            self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def grads(self):
        """Every group's gradients: Adam's, then SGD's."""
        return [p.grad for p in self.all_params]

    @property
    def all_params(self):
        return self.params + (self.sgd.params if self.sgd else [])

    @property
    def _moments(self):
        """The state an update replaces: Adam's moments, the SGD trace."""
        return [*self.exp_avg, *self.exp_avg_sq,
                *(self.sgd.trace if self.sgd else [])]

    def tensors(self):
        """Every state tensor (moments, trace, counts), in a fixed
        order."""
        return [*self._moments, self.count, self.skipped]

    @torch.no_grad()
    def begin(self, batch_count) -> None:
        """Before the backward of batch ``batch_count`` (0-d): clear the
        gradient sums.  With accumulation, only where the batch starts a
        new sum, by MultiSteps' multiply by ``1 - emit``, so a sum that
        holds a NaN stays NaN, as in ``ctc_tpu``."""
        if self.accum_grad == 1:
            torch._foreach_zero_(self.grads)
        else:
            keep = (batch_count % self.accum_grad != 0).to(torch.float32)
            torch._foreach_mul_(self.grads, keep)

    @torch.no_grad()
    def step(self, batch_count, lr) -> dict:
        """The update after the backward of batch ``batch_count`` (0-d),
        with learning rate ``lr`` (a float or a 0-d tensor).  Returns the
        guards' metrics: with ``grad_norm_freq``, ``grad_norm``,
        ``grad_norm_step`` (the count before the update) and
        ``grad_norm_due``."""
        grads = self.grads
        out = {}
        if self.grad_norm_freq:
            norm, due = log_grad_norms(grads, self.count, self.grad_norm_freq)
            out = {"grad_norm": norm, "grad_norm_step": self.count.clone(),
                   "grad_norm_due": due}
        b1, b2 = self.betas
        params = self.params
        adam_grads = grads[:len(params)]
        g = (torch._foreach_add(adam_grads, params, alpha=self.weight_decay)
             if self.weight_decay else adam_grads)
        m = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                               torch._foreach_mul(self.exp_avg, b1))
        v = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(self.exp_avg_sq, b2))
        count = self.count + 1
        m_hat = torch._foreach_div(m, 1 - b1 ** count)
        v_hat = torch._foreach_div(v, 1 - b2 ** count)
        upd = torch._foreach_div(
            m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps))
        upd = torch._foreach_mul(upd, -lr)
        moments = [*m, *v]
        if self.sgd:
            sgd_upd, trace = self.sgd.candidates(self.count)
            params, upd = self.all_params, [*upd, *sgd_upd]
            moments += trace
        emit = None
        if self.accum_grad > 1:
            emit = batch_count % self.accum_grad == self.accum_grad - 1
        if self.skip_nonfinite:
            skip_nonfinite_updates(
                grads, [*params, *self._moments, self.count],
                [*torch._foreach_add(params, upd), *moments, count],
                self.skipped, when=emit)
            return out
        if emit is None:
            torch._foreach_add_(params, upd)
            new_state = [*moments, count]
        else:
            # MultiSteps adds emit * update, so a NaN update reaches the
            # parameters on a mini-step too, as in ctc_tpu
            torch._foreach_add_(params, torch._foreach_mul(
                upd, emit.to(torch.float32)))
            new_state = [torch.where(emit, n, o) for n, o in zip(
                [*moments, count], [*self._moments, self.count])]
        for cur, new in zip([*self._moments, self.count], new_state):
            cur.copy_(new)
        return out

    def state_dict(self) -> dict:
        out = {"exp_avg": list(self.exp_avg),
               "exp_avg_sq": list(self.exp_avg_sq),
               "count": self.count, "skipped": self.skipped}
        if self.sgd:
            out["momentum"] = list(self.sgd.trace)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` into the existing tensors (in place).

        Raises ``ValueError`` where ``state`` has another structure than
        this optimizer, as ``ctc_tpu``'s restore against its template
        does: a frozen backbone's state (no ``"momentum"``) resumed under
        ``--finetune-i3d``, the reverse, or another set or shape of
        parameters."""
        if ("momentum" in state) != (self.sgd is not None):
            raise ValueError(
                "optimizer state does not match this optimizer: the "
                "checkpoint was saved with the backbone "
                + ("trained" if "momentum" in state else "frozen")
                + ", and this run has it "
                + ("trained" if self.sgd is not None else "frozen")
                + " (--finetune-i3d)")
        saved = [*state["exp_avg"], *state["exp_avg_sq"],
                 *state.get("momentum", []), state["count"],
                 state["skipped"]]
        current = self.tensors()
        if len(saved) != len(current) or any(
                torch.as_tensor(new).shape != cur.shape
                for cur, new in zip(current, saved)):
            raise ValueError(
                "optimizer state does not match this optimizer: "
                f"{len(saved)} saved tensors against {len(current)}, or "
                "another shape")
        for cur, new in zip(current, saved, strict=True):
            cur.copy_(torch.as_tensor(new))


#: ``ctc_tpu``'s name for the optimizer: ``torch_style_adam(params,
#: weight_decay, accum_grad=, skip_nonfinite=, grad_norm_freq=)``
torch_style_adam = TorchStyleAdam
