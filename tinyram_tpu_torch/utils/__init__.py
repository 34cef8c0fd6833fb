from .profiling import KernelCounters, counters, recording, span

__all__ = ["KernelCounters", "counters", "recording", "span"]
