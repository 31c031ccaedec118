"""moc_tpu_torch.parallel — the single-device half of ``moc_tpu.parallel``:
LongNet dilated attention with lse branch recombination (``dilated``) and
GShard-style MoE with top-1/top-2 gating, static capacity and the aux
load-balancing loss (``moe``). The mesh helpers, ring attention, the GPipe
schedule, the multi-process runtime and the cross-device branches of
dilated attention and MoE wait for the multi-device half of ROADMAP queue
1, item 9."""

from moc_tpu_torch.parallel.dilated import DilatedConfig, dilated_attention
from moc_tpu_torch.parallel.moe import (MoEConfig, MoELayer, capacity_for, moe_dispatch_combine,
                                        top1_gate, top2_gate)

__all__ = ["DilatedConfig", "MoEConfig", "MoELayer", "capacity_for", "dilated_attention",
           "moe_dispatch_combine", "top1_gate", "top2_gate"]
