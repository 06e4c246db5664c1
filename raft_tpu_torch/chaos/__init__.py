"""The chaos plane of the port (raft_tpu/chaos/): fault injection in the
fabric and the recovery SLO probe.

- `device`: the `ChaosState` carry and the round hooks around every fused
  round (drop, duplicate, partition, tick skew, crash/restart, probe).
- `schedule`: the host plane, `ChaosSchedule`, `ChaosRunner` and
  `RecoveryProbe`.
"""

from raft_tpu_torch.chaos.device import (  # noqa: F401
    NEVER,
    P_ONE,
    ChaosState,
    init_chaos,
    probability,
)
from raft_tpu_torch.chaos.schedule import (  # noqa: F401
    ChaosRunner,
    ChaosSchedule,
    RecoveryProbe,
    trajectory_digest,
)
