"""Device meshes (port of ``ctc_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``(data, model)`` or ``(data, seq)`` array and
runs one program over all of them.  The port maps that array onto
processes:

* the ``data`` axis is the ranks of a ``torch.distributed`` process group,
  and rank ``d`` owns row ``d`` of the mesh;
* a row's ``model`` or ``seq`` shards run single-controller inside the
  rank, one ``torch.device`` per shard, in turn.  Devices may repeat: on
  the CPU every shard is ``cpu`` (the role of the JAX suite's virtual CPU
  devices), on a one-card machine every shard of every rank is ``cuda:0``.
  A shard count is what the caller asks for and never shrinks to the
  number of cards.

A rank's row is ``cuda:((local_rank * second + j) % device_count)`` for
``j < second``, where ``local_rank`` is the rank's index among its host's
ranks.  The process group's backend follows from that layout
(:func:`pick_backend`): NCCL where every local rank's first device is a
card of its own, gloo where ranks share a card or run on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: its row of ``model`` or ``seq`` shards
    (shard ``k`` runs on ``devices[k]``), and, where the mesh has a data
    axis, the process group whose ranks are that axis.

    ``data`` is None for a mesh without a data axis (the seq or model
    shards of one process); ``group`` is None where the data axis has one
    rank and no process group was made for it, and collectives over it
    are then the identity.  ``hosts`` splits the ranks into equal blocks of
    consecutive ranks, one block a host."""

    devices: tuple[torch.device, ...]
    axis: str = SEQ_AXIS
    data: int | None = None
    group: object = None
    rank: int = 0
    hosts: int = 1
    backend: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        out = {} if self.data is None else {DATA_AXIS: self.data}
        out[self.axis] = len(self.devices)
        return out

    @property
    def local_ranks(self) -> int:
        """Ranks on this rank's host."""
        return (self.data or 1) // self.hosts

    @property
    def local_rank(self) -> int:
        """This rank's index among its host's ranks."""
        return self.rank % self.local_ranks

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; every rank reads them."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank of the data axis."""
        if self.group is not None:
            dist.barrier(group=self.group)


def make_seq_mesh(n: int, device="cuda") -> Mesh:
    """An ``n``-shard seq mesh with every shard on ``device`` (the card
    unless the caller asks for the CPU), without a data axis."""
    return make_local_mesh(SEQ_AXIS, n, device)


def make_local_mesh(axis: str, n: int, device="cuda") -> Mesh:
    """An ``n``-shard ``axis`` mesh of one process, every shard on
    ``device``: the class or T shards of a run without a data axis."""
    if n < 1:
        raise ValueError(f"a {axis} mesh needs at least one shard, got {n}")
    return Mesh(devices=(torch.device(device),) * n, axis=axis)


def rank_devices(device, local_rank: int, second: int) -> tuple:
    """The ``second`` devices of a rank's row: ``cuda:((local_rank *
    second + j) % device_count)``; every shard of every rank on the CPU
    when ``device`` is the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,) * second
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", (local_rank * second + j) % count)
                 for j in range(second))


def pick_backend(device, local_ranks: int, second: int = 1) -> str:
    """The process group's backend for ``local_ranks`` ranks a host: NCCL
    when every local rank's first device is a card of its own, else gloo
    (ranks that share a card, or the CPU).  NCCL refuses two ranks on one
    card; gloo runs collectives on CUDA tensors through the host."""
    if torch.device(device).type != "cuda":
        return "gloo"
    firsts = {rank_devices(device, lr, second)[0] for lr in range(local_ranks)}
    return "nccl" if len(firsts) == local_ranks else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str = "nccl") -> None:
    """Join the default process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator`` (``host:port``, where rank 0
    listens); a no-op for one process, as ``jax.distributed.initialize``'s
    wrapper is.  ``backend`` as :func:`pick_backend` gives it."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address host:port")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def init_single_rank(backend: str = "nccl") -> None:
    """A process group of one rank in this process (``--data-parallel
    1``): its collectives run, so the one-rank data path is the many-rank
    one, and under NCCL a CUDA graph can capture them."""
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)


def make_mesh(data: int | None = None, model: int = 1, seq: int = 1, *,
              devices=None, device="cuda", hosts: int = 1) -> Mesh:
    """This rank's row of a ``(data, model)`` or ``(data, seq)`` mesh.

    The data axis is the default process group: ``data=None`` takes all
    of its ranks (one when there is no group), and a group of another size
    than ``data`` is refused.  ``model`` > 1 adds the class-sharding axis of
    the binary lattice stack, ``seq`` > 1 the T pipeline instead; the two
    second axes are alternatives.

    ``devices``, as in JAX, lists the whole mesh's devices, row by row
    (``data * second`` of them, or a multiple of ``second`` when ``data``
    is None); by default a rank's row is :func:`rank_devices` of
    ``device`` at its local rank.  ``hosts`` is the number of hosts the
    ranks are spread over, in equal blocks of consecutive ranks."""
    if model > 1 and seq > 1:
        raise ValueError("pick one second axis: model or seq, not both")
    second = max(model, seq)
    second_name = SEQ_AXIS if seq > 1 else MODEL_AXIS
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if data is None:
            if len(devices) % second:
                raise ValueError(f"{len(devices)} devices not divisible by "
                                 f"{second_name}={second}")
            data = len(devices) // second
        if data * second > len(devices):
            raise ValueError(f"a {data} x {second} mesh needs {data * second}"
                             f" devices, got {len(devices)}")
    if data is None:
        data = world
    if data != world:
        raise ValueError(
            f"data={data} needs a process group of {data} ranks, found "
            f"{world}: start the ranks (cli.main --data-parallel, or "
            "init_distributed) before make_mesh")
    if data % hosts:
        raise ValueError(f"{data} ranks do not split over {hosts} hosts")
    if devices is not None:
        row = tuple(devices[rank * second:(rank + 1) * second])
    else:
        row = rank_devices(device, rank % (data // hosts), second)
    backend = dist.get_backend() if group is not None else None
    return Mesh(devices=row, axis=second_name, data=data, group=group,
                rank=rank, hosts=hosts, backend=backend)
