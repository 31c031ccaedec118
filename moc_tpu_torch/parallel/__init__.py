"""moc_tpu_torch.parallel — PyTorch port of ``moc_tpu.parallel``, on
``torch.distributed``: one process a rank (``runtime``), meshes of ranks
with a process group per axis (``mesh``), the ``lax`` collectives with
their transposes as backwards (``collectives``), ring attention over K2–K4
(``ring``), LongNet dilated attention with its cross-shard segments
(``dilated``), GShard MoE with expert parallelism (``moe``) and the GPipe
schedule (``pipeline``). ``launch`` starts a world of ranks as processes.
"""

from moc_tpu_torch.parallel.dilated import DilatedConfig, dilated_attention
from moc_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ,
                                         AXIS_TENSOR, make_hybrid_mesh, make_mesh, shard_spec)
from moc_tpu_torch.parallel.moe import (MoEConfig, MoELayer, capacity_for, moe_dispatch_combine,
                                        top1_gate, top2_gate)
from moc_tpu_torch.parallel.pipeline import pipeline_apply
from moc_tpu_torch.parallel.ring import ring_attention
from moc_tpu_torch.parallel.runtime import (barrier, broadcast_from_leader, host_local_to_global,
                                            initialize_runtime)

__all__ = ["AXIS_DATA", "AXIS_EXPERT", "AXIS_PIPE", "AXIS_SEQ", "AXIS_TENSOR", "DilatedConfig",
           "MoEConfig", "MoELayer", "barrier", "broadcast_from_leader", "capacity_for",
           "dilated_attention", "host_local_to_global", "initialize_runtime",
           "make_hybrid_mesh", "make_mesh", "moe_dispatch_combine", "pipeline_apply",
           "ring_attention", "shard_spec", "top1_gate", "top2_gate"]
