"""Device meshes (port of ``ctc_tpu/parallel/mesh.py``, the ``seq`` axis).

JAX shards the sequence-parallel lattice with ``shard_map`` over a ``seq``
mesh axis, one program driving all shards.  The port keeps that single
controller: one process holds a :class:`SeqMesh`, a shard count and one
``torch.device`` per shard, and runs the shards in turn.  Devices may
repeat: on the CPU every shard is ``cpu`` (the role of the JAX suite's
virtual CPU devices), on a one-card machine every shard is ``cuda:0``.  The
shard count is what the caller asks for and never shrinks to the number of
cards, so interior shards run wherever the mesh does.

The data axis (``make_mesh``: DDP with a process-group transport, and the
data x seq and data x model compositions) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SEQ_AXIS = "seq"


@dataclass(frozen=True)
class SeqMesh:
    """The shards of the lattice's T axis: shard ``k`` runs on
    ``devices[k]``."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        return {SEQ_AXIS: len(self.devices)}


def make_seq_mesh(n: int, device="cuda") -> SeqMesh:
    """An ``n``-shard seq mesh with every shard on ``device`` (the card
    unless the caller asks for the CPU)."""
    if n < 1:
        raise ValueError(f"a seq mesh needs at least one shard, got {n}")
    return SeqMesh(devices=(torch.device(device),) * n)


def make_mesh(data=None, model: int = 1, seq: int = 1, *, devices=None):
    """The ``(data, model)`` / ``(data, seq)`` mesh of ``ctc_tpu``; not
    ported yet."""
    raise NotImplementedError(
        "make_mesh (the data axis and its compositions) is not ported to "
        "ctc_tpu_torch yet (ROADMAP.md Queue 1 item 14); a seq-only mesh is "
        "make_seq_mesh"
    )
