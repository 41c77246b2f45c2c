"""Discrete-event simulation of the paper's Section 6 experiments."""
from repro_torch.sim.metrics import GridResult, SimResult, mean_ci95  # noqa: F401
from repro_torch.sim.simulator import (  # noqa: F401
    run_policies,
    simulate,
    simulate_batched,
)
from repro_torch.sim.sweep import GridSpec, pad_streams, simulate_grid  # noqa: F401
from repro_torch.sim.workload import (  # noqa: F401
    WorkloadParams,
    generate,
    generate_filtered,
)
