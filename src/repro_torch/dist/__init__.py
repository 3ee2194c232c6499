"""Distribution layer: sharding rules, quantized collectives, pipelining.
Counterpart of ``repro/dist``, over ``torch.distributed`` (NCCL on the card,
gloo on the CPU), one rank a device:

  * ``sharding``    — the spec of every param leaf of every arch (model axis
                      on attention/FFN projections, (data, model) on MoE
                      expert stacks) and its DTensor placements on a
                      `DeviceMesh`,
  * ``collectives`` — int8-on-the-wire gradient all-reduce with per-leaf
                      scales, and the pipeline's quantized hop,
  * ``pipeline``    — GPipe and 1F1B microbatch pipelining over a mesh axis.
"""
from repro_torch.dist import collectives, pipeline, sharding  # noqa: F401
