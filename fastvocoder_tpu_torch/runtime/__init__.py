"""Training runtime: step timing, tracing and prefetch to the device."""

from fastvocoder_tpu_torch.runtime.prefetch import prefetch_to_device
from fastvocoder_tpu_torch.runtime.profiler import StepTimer, annotate, trace

__all__ = ["StepTimer", "annotate", "trace", "prefetch_to_device"]
