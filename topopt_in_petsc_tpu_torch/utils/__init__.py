from topopt_in_petsc_tpu_torch.utils.profiling import (
    trace_to,
    speed_of_light_spmv,
)

__all__ = ["trace_to", "speed_of_light_spmv"]
