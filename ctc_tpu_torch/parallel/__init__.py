"""Parallelism (port of ``ctc_tpu/parallel``): so far the seq mesh and the
sequence-sharded lattice pipeline and greedy decode."""

from ctc_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    SeqMesh,
    make_mesh,
    make_seq_mesh,
)
from ctc_tpu_torch.parallel.seq_lattice import (
    make_seq_sharded_greedy_decode,
    make_seq_sharded_lattice_nll,
    make_seq_sharded_loss,
    shard_time_axis,
)

__all__ = [
    "SEQ_AXIS",
    "SeqMesh",
    "make_mesh",
    "make_seq_mesh",
    "make_seq_sharded_greedy_decode",
    "make_seq_sharded_lattice_nll",
    "make_seq_sharded_loss",
    "shard_time_axis",
]
