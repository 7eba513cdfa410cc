"""repro_torch.serving — continuous batching over the port's Session.

Copies of the host-side pieces of ``repro.serving`` (slot and page pools,
radix prefix sharing, FIFO scheduler, sampling, the engine), driving a
``repro_torch`` session instead of a jax one. See ``repro.serving`` for
the design.
"""

from repro_torch.serving.engine import EngineStats, ServeEngine
from repro_torch.serving.paging import PageAllocation, PagePool, PagedSlotPool
from repro_torch.serving.radix import RadixIndex
from repro_torch.serving.sampling import SamplingParams, sample_token
from repro_torch.serving.scheduler import (
    MoECapacity,
    Request,
    RequestScheduler,
    SchedulerPolicy,
)
from repro_torch.serving.slots import SlotPool, SlotView

__all__ = [
    "EngineStats",
    "MoECapacity",
    "PageAllocation",
    "PagePool",
    "PagedSlotPool",
    "RadixIndex",
    "Request",
    "RequestScheduler",
    "SamplingParams",
    "SchedulerPolicy",
    "ServeEngine",
    "SlotPool",
    "SlotView",
    "sample_token",
]
