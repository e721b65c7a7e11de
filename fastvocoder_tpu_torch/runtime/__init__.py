"""Training runtime: the program's spans, tracing and prefetch to the
device."""

from fastvocoder_tpu_torch.runtime.prefetch import prefetch_to_device
from fastvocoder_tpu_torch.runtime.profiler import annotate, trace

__all__ = ["annotate", "trace", "prefetch_to_device"]
