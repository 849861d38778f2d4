"""The optimizer chain of ``ctc_tpu/train/trainer.py:466-518`` with every
count on the device.

``ctc_tpu`` composes optax transforms::

    MultiSteps(skip_nonfinite_updates(chain(log_grad_norms,
        add_decayed_weights, scale_by_adam, scale_by_learning_rate)))

:class:`TorchStyleAdam` does the same arithmetic over tensors that live on
the parameters' device and are updated in place, so that their addresses
never change and a captured CUDA graph can hold them:

* Adam's moments ``exp_avg`` / ``exp_avg_sq``;
* ``count``: the optimizer updates so far, which drive Adam's bias
  correction and the learning-rate schedule (optax keeps one count in
  each; they move together); a skipped update does not move it;
* ``skipped``: updates dropped by ``skip_nonfinite``.

Gradients accumulate in each parameter's ``.grad``, allocated once here
and never set to None.  Whether a batch ends an accumulation comes from
the batch count (the train state's ``step``), so nothing is decided on the
host.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.train.guards import log_grad_norms, skip_nonfinite_updates


class TorchStyleAdam:
    """``torch.optim.Adam(lr, weight_decay)``: L2 added to the raw gradient,
    then Adam, then ``-lr`` with ``lr`` read from the schedule at the count
    before the update.

    ``accum_grad`` k > 1 sums the gradients of k batches and steps on the
    k-th (``optax.MultiSteps(use_grad_mean=False)``); ``skip_nonfinite``
    drops an update whose summed gradient is not finite and keeps the
    parameters and every count; ``grad_norm_freq`` n > 0 reports the
    global norm of the summed gradient at each batch whose count is a
    multiple of n.
    """

    def __init__(self, params, weight_decay: float = 0.0, *,
                 accum_grad: int = 1, skip_nonfinite: bool = False,
                 grad_norm_freq: int = 0, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = list(params)
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
        return [p.grad for p in self.params]

    def tensors(self):
        """Every state tensor (moments, counts), in a fixed order."""
        return [*self.exp_avg, *self.exp_avg_sq, self.count, self.skipped]

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
        params, grads = self.params, self.grads
        out = {}
        if self.grad_norm_freq:
            norm, due = log_grad_norms(grads, self.count, self.grad_norm_freq)
            out = {"grad_norm": norm, "grad_norm_step": self.count.clone(),
                   "grad_norm_due": due}
        b1, b2 = self.betas
        g = (torch._foreach_add(grads, params, alpha=self.weight_decay)
             if self.weight_decay else grads)
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
        emit = None
        if self.accum_grad > 1:
            emit = batch_count % self.accum_grad == self.accum_grad - 1
        if self.skip_nonfinite:
            skip_nonfinite_updates(
                grads, [*params, *self.exp_avg, *self.exp_avg_sq, self.count],
                [*torch._foreach_add(params, upd), *m, *v, count],
                self.skipped, when=emit)
            return out
        if emit is None:
            torch._foreach_add_(params, upd)
            new_state = [*m, *v, count]
        else:
            # MultiSteps adds emit * update, so a NaN update reaches the
            # parameters on a mini-step too, as in ctc_tpu
            torch._foreach_add_(params, torch._foreach_mul(
                upd, emit.to(torch.float32)))
            new_state = [torch.where(emit, n, o) for n, o in zip(
                [*m, *v, count], [*self.exp_avg, *self.exp_avg_sq,
                                  self.count])]
        for cur, new in zip([*self.exp_avg, *self.exp_avg_sq, self.count],
                            new_state):
            cur.copy_(new)
        return out

    def state_dict(self) -> dict:
        return {"exp_avg": list(self.exp_avg),
                "exp_avg_sq": list(self.exp_avg_sq),
                "count": self.count, "skipped": self.skipped}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` into the existing tensors (in place)."""
        for cur, new in zip(self.tensors(),
                            [*state["exp_avg"], *state["exp_avg_sq"],
                             state["count"], state["skipped"]]):
            cur.copy_(torch.as_tensor(new))


#: ``ctc_tpu``'s name for the optimizer: ``torch_style_adam(params,
#: weight_decay, accum_grad=, skip_nonfinite=, grad_norm_freq=)``
torch_style_adam = TorchStyleAdam
