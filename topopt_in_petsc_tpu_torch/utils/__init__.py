from topopt_in_petsc_tpu_torch.utils.timers import Timer, timed
from topopt_in_petsc_tpu_torch.utils.profiling import (
    trace_to,
    speed_of_light_spmv,
)

__all__ = ["Timer", "timed", "trace_to", "speed_of_light_spmv"]
