from graphtpu_torch.utils.logging import Log, StopWatch
from graphtpu_torch.utils.metrics import StepMetrics, trace_profile

__all__ = ["Log", "StopWatch", "StepMetrics", "trace_profile"]
