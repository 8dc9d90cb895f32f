"""Canonical mesh-axis names, copied from ``autodist_tpu/const.py``.

The port keeps its own copy so that it never imports the JAX package.
Only the names are copied: the environment-variable plane of the JAX
package is not part of the serving slice.
"""

DATA_AXIS = "data"       # data parallelism
DCN_AXIS = "dcn"         # cross-slice data parallelism
MODEL_AXIS = "model"     # tensor/model parallelism
SEQ_AXIS = "seq"         # sequence/context parallelism
PIPE_AXIS = "pipe"       # pipeline parallelism
EXPERT_AXIS = "expert"   # expert parallelism (MoE)

ALL_AXES = (DATA_AXIS, DCN_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS,
            EXPERT_AXIS)
