"""Canonical mesh-axis names and the environment variables the port
reads, copied from ``autodist_tpu/const.py``.

The port keeps its own copy so that it never imports the JAX package.
The variables keep the JAX package's names, so that one job configures
both packages alike: :class:`ENV` holds the ones the coordination
service, the SSP gate and the asynchronous PS read, and the env plane
the launcher (:mod:`autodist_tpu_torch.runtime.cluster`) writes for
every worker and :meth:`~autodist_tpu_torch.resource.ResourceSpec
.bootstrap` reads.
"""
import enum
import os
import tempfile

DATA_AXIS = "data"       # data parallelism
DCN_AXIS = "dcn"         # cross-slice data parallelism
MODEL_AXIS = "model"     # tensor/model parallelism
SEQ_AXIS = "seq"         # sequence/context parallelism
PIPE_AXIS = "pipe"       # pipeline parallelism
EXPERT_AXIS = "expert"   # expert parallelism (MoE)

ALL_AXES = (DATA_AXIS, DCN_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS,
            EXPERT_AXIS)


class ENV(enum.Enum):
    """Typed environment flags (JAX ``const.ENV``): each member's value
    is a function from the raw string (``None`` when unset) to the typed
    value."""

    # Non-chief marker and worker name (empty on the chief).
    AUTODIST_TPU_WORKER = (lambda v: v or "",)
    # Processes of the job; the SSP gate's registration barrier waits
    # for this many workers when it is above 1.
    AUTODIST_TPU_NUM_PROCESSES = (lambda v: int(v) if v else 1,)
    # host:port of the coordination service (runtime/coordination.py).
    AUTODIST_TPU_COORD_SERVICE = (lambda v: v or "",)
    # The shared secret every coordination connection presents
    # (generated by the chief's CoordServer when unset, and exported to
    # its environment for in-process clients and launched workers).
    AUTODIST_TPU_COORD_TOKEN = (lambda v: v or "",)
    # The interface the coordination server binds ("" = all).
    AUTODIST_TPU_COORD_BIND = (lambda v: v or "",)
    # The strategy a worker loads from the chief (the id it was
    # published under, ``strategy/<id>`` on the coordination service).
    AUTODIST_TPU_STRATEGY_ID = (lambda v: v or "",)
    # This process's rank in the job, and the rendezvous (host:port) of
    # the job's torch.distributed store, which rank 0 serves.
    AUTODIST_TPU_PROCESS_ID = (lambda v: int(v) if v else 0,)
    AUTODIST_TPU_COORDINATOR = (lambda v: v or "",)
    # The project logger's level and its files' directory.
    AUTODIST_TPU_MIN_LOG_LEVEL = (lambda v: v or "INFO",)
    AUTODIST_TPU_WORKING_DIR = (
        lambda v: v or os.path.join(tempfile.gettempdir(),
                                    "autodist_tpu_torch"),)
    # A fault plan (runtime/faults.py): inline JSON or @path.
    AUTODIST_TPU_FAULT_PLAN = (lambda v: v or "",)
    # 0 for a worker's first start; n after its n-th supervised restart.
    AUTODIST_TPU_WORKER_INCARNATION = (lambda v: int(v) if v else 0,)

    @property
    def val(self):
        """The typed value of this variable."""
        return self.value[0](os.environ.get(self.name))
