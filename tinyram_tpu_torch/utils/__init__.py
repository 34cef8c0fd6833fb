from .profiling import KernelCounters, profile_region, counters

__all__ = ["KernelCounters", "profile_region", "counters"]
