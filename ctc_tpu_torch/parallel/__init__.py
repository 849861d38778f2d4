"""Parallelism (port of ``ctc_tpu/parallel``): the mesh over processes and
devices, the collectives, the data-parallel steps, the class-sharded
binary loss and the sequence-sharded lattice pipeline and greedy decode."""

from ctc_tpu_torch.parallel.class_sharded import (
    make_class_sharded_binary_loss,
    make_class_sharded_binary_nll,
    shard_class_axis,
)
from ctc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    init_distributed,
    make_local_mesh,
    make_mesh,
    make_seq_mesh,
)
from ctc_tpu_torch.parallel.seq_lattice import (
    make_seq_sharded_greedy_decode,
    make_seq_sharded_lattice_nll,
    make_seq_sharded_loss,
    shard_time_axis,
)
from ctc_tpu_torch.parallel.steps import (
    make_sharded_eval_step,
    make_sharded_multi_eval_step,
    make_sharded_multi_train_step,
    make_sharded_train_step,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "init_distributed",
    "make_class_sharded_binary_loss",
    "make_class_sharded_binary_nll",
    "make_local_mesh",
    "make_mesh",
    "make_seq_mesh",
    "make_seq_sharded_greedy_decode",
    "make_seq_sharded_lattice_nll",
    "make_seq_sharded_loss",
    "make_sharded_eval_step",
    "make_sharded_multi_eval_step",
    "make_sharded_multi_train_step",
    "make_sharded_train_step",
    "replicate",
    "shard_batch",
    "shard_class_axis",
]
