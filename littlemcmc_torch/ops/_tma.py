"""The shared-memory limits of the batched model kernels' TMA ring
(``csrc/tma_ring.cuh``), by which :func:`~.logistic.plan_logistic` and
:func:`~.quadform.plan_quadform` size their launches; the header holds the
same numbers and the C launchers check the planners' bytes against them."""

MAX_SMEM_BYTES = 232_448  # kMaxSmemBytes: the dynamic shared memory a block may use on sm_90
BARRIER_BYTES = 128  # kBarrierBytes: the ring's mbarriers at the front of shared memory
MAX_STAGES = 16  # kMaxStages: one 8-byte barrier a stage
