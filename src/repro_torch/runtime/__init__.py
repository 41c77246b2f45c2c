"""Fleet runtime: AR scheduling of ML jobs on the card fleet."""
from repro_torch.runtime.fleet import (  # noqa: F401
    FleetJob,
    FleetScheduler,
    JobState,
    PartitionedCore,
    estimate_duration,
)
