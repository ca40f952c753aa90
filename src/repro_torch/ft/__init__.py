"""step.ft on PyTorch: checkpoints, heartbeats and elastic recovery (port of
:mod:`repro.ft`)."""

from repro_torch.ft.checkpoint import (
    AsyncCheckpointer,
    Checkpoint,
    latest_step,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ft.elastic import (RecoveryPlan, elastic_restore, plan_recovery,
                                    rebalance_batch, rebalance_shards, reshard_tree,
                                    session_recovery)
from repro_torch.ft.heartbeat import (HeartbeatMonitor, PAYLOAD_KEYS,
                                      REBALANCE_KEYS, metrics_payload)

__all__ = [
    "AsyncCheckpointer", "Checkpoint", "latest_step", "list_checkpoints",
    "restore_checkpoint", "save_checkpoint",
    "RecoveryPlan", "elastic_restore", "plan_recovery", "rebalance_batch",
    "rebalance_shards", "reshard_tree", "session_recovery",
    "HeartbeatMonitor", "PAYLOAD_KEYS", "REBALANCE_KEYS", "metrics_payload",
]
