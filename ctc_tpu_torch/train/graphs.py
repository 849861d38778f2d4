"""K train (or eval) steps as one unit (port of ``ctc_tpu``'s
``make_multi_train_step`` / ``make_multi_eval_step``, which run K steps as
one jitted ``lax.scan``, ``ctc_tpu/train/trainer.py:268-322``).

On the card the K steps are one CUDA graph, captured once per shape
signature of the group's batches and replayed once per group of K
batches: the LSTM head, the loss through the lattice kernels, backward,
the guards, the accumulation and Adam, each step the same function the
eager path calls.  On the CPU (tests) the same K steps run in turn.

Capture, on the card:

* the group's batches are copied into static ``[K, B, ...]`` buffers on
  the device (through pinned host buffers) before every replay;
* the first group of a shape runs its K steps eagerly on a side stream
  (PyTorch's warm-up before a capture: it builds and loads the kernels and
  sets up autograd's and cuBLAS's state), and the graph is captured after
  it; every later group of that shape is one replay.  The warm-up is that
  group's training, so every batch is trained once and every kernel
  launch is a batch's;
* the dropout generator is registered with the graph, so each replay
  draws fresh masks and moves the generator on as K eager steps would;
* the state is held by address: restoring a checkpoint copies into it
  (``checkpoints.load``), and a new model, optimizer or batch count
  triggers a new capture;
* a capture that fails raises; there is no fallback to eager steps.

The lattice wrappers' launch counters are Python integers: they tick at
the warm-up's launches and while the steps are captured, not at a replay.
"""

from __future__ import annotations

import numpy as np
import torch


def stack_metrics(rows) -> dict:
    """A list of per-step metric dicts of 0-d tensors -> ``{key: [K]}``."""
    return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}


def host_rows(metrics) -> list[dict]:
    """``{key: [K]}`` on the device -> K dicts of Python floats, read with
    one copy to the host."""
    keys = list(metrics)
    table = torch.stack([metrics[k].to(torch.float64) for k in keys], 1)
    return [dict(zip(keys, row)) for row in table.tolist()]


def as_tensor(value) -> torch.Tensor:
    """A batch field as a tensor: a tensor as it is, an array without a
    copy."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


def to_device(batch, device) -> dict:
    """Batch dict (numpy arrays, or tensors from ``device_prefetch``) ->
    tensors on ``device``."""
    return {k: as_tensor(v).to(device) for k, v in batch.items()}


def signature(batch) -> tuple:
    """A batch's fields' shapes and dtypes, by key."""
    return tuple((key, tuple(t.shape), t.dtype)
                 for key, t in ((k, as_tensor(v)) for k, v in batch.items()))


def stack_group(group, device) -> dict:
    """The group's batches stacked on a new leading axis, on ``device``."""
    return {key: torch.stack([as_tensor(b[key]).to(device) for b in group])
            for key in group[0]}


class _Captured:
    """One captured graph, its static inputs and outputs, and what it
    holds by address."""

    def __init__(self, sig, k, device):
        self.inputs = {key: torch.empty((k, *shape), dtype=dtype,
                                        device=device)
                       for key, shape, dtype in sig}
        self.host = {key: torch.empty((k, *shape), dtype=dtype,
                                      pin_memory=True)
                     for key, shape, dtype in sig}
        self.copied = torch.cuda.Event()
        self.graph = None
        self.out = None
        self.owner = None

    def load(self, group) -> None:
        """Copy the group's batches into the static inputs: host arrays
        through the pinned buffers (after the last group's copy out of
        them has finished), device tensors directly."""
        self.copied.synchronize()
        for key, dst in self.inputs.items():
            first = group[0][key]
            if isinstance(first, torch.Tensor):
                for j, b in enumerate(group):
                    dst[j].copy_(b[key], non_blocking=True)
            else:
                np.stack([np.asarray(b[key]) for b in group],
                         out=self.host[key].numpy())
                dst.copy_(self.host[key], non_blocking=True)
        self.copied.record()


def _owner(state):
    return (state.model, state.optimizer, state.step)


class MultiStep:
    """K calls of ``step`` over a group of K batches of one signature.

    ``step`` is a train step ``(state, batch, generator) -> (state,
    metrics)`` when ``train``, else an eval step ``(state, batch) ->
    metrics``.  Calling the object with ``(state, group)`` runs the group
    and returns its metrics as ``{key: [K]}`` tensors on the device."""

    def __init__(self, step, k: int, *, train: bool, device,
                 generator: torch.Generator | None = None):
        self.step = step
        self.k = k
        self.train = train
        self.device = torch.device(device)
        self.generator = generator
        self._captured: dict[tuple, _Captured] = {}

    def body(self, state, inputs) -> dict:
        """The K steps over the stacked ``inputs`` (what a graph holds)."""
        rows = []
        for j in range(self.k):
            batch = {key: v[j] for key, v in inputs.items()}
            if self.train:
                state, m = self.step(state, batch, self.generator)
            else:
                m = self.step(state, batch)
            rows.append(m)
        return stack_metrics(rows)

    def __call__(self, state, group) -> dict:
        if len(group) != self.k:
            raise ValueError(f"a group holds {self.k} batches, got "
                             f"{len(group)}")
        if self.device.type != "cuda":
            return self.body(state, stack_group(group, self.device))
        sig = signature(group[0])
        cap = self._captured.get(sig)
        if cap is not None and all(a is b for a, b in
                                   zip(cap.owner, _owner(state))):
            cap.load(group)
            cap.graph.replay()
            return cap.out
        cap = _Captured(sig, self.k, self.device)
        cap.load(group)
        out = self._warm_up_and_capture(cap, state)
        self._captured[sig] = cap
        return out

    def _warm_up_and_capture(self, cap: _Captured, state) -> dict:
        """Run the group's K steps eagerly on a side stream, then capture
        them over the same static inputs; returns the eager run's
        metrics."""
        device = self.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = self.body(state, cap.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gen = None
        if self.train and self.generator is not None:
            graph.register_generator_state(self.generator)
            gen = self.generator.get_state()
        try:
            with torch.cuda.graph(graph):
                cap.out = self.body(state, cap.inputs)
        except Exception as e:
            kind = "train" if self.train else "eval"
            raise RuntimeError(
                f"CUDA graph capture of {self.k} {kind} steps failed "
                f"({type(e).__name__}: {e}); --steps-per-dispatch has no "
                "eager fallback on the card") from e
        finally:
            if gen is not None:
                # a capture runs nothing: the generator stays where the
                # warm-up left it
                self.generator.set_state(gen)
        cap.graph, cap.owner = graph, _owner(state)
        return out
