"""Federated learning of the port: local training with Keras-callback
semantics, the encrypted FedAvg round on one device or across the client
mesh (robust and private: `faults`, `dp`), the streaming aggregation
service (`stream`, `journal`, `server`; flat or through the host tiers of
`hierarchy`, on one device or across the client mesh), and evaluation.

Re-exports the names of `hefl_tpu.fl`; `produce_uploads` takes a
torch.Generator in place of a key."""

from hefl_tpu_torch.fl.client import local_train, train_centralized
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import (
    DpConfig,
    calibration_clients,
    clip_by_global_norm,
    dp_sanitize,
    epsilon_spent,
)
from hefl_tpu_torch.fl.faults import (
    ArrivalFaults,
    CrashConfig,
    DeviceLost,
    FaultConfig,
    LinkFaults,
    RoundFaults,
    RoundMeta,
    SimulatedCrash,
    schedule_arrivals,
    schedule_for_round,
    schedule_links,
)
from hefl_tpu_torch.fl.fedavg import cohort_bucket, evaluate, fedavg_round, train_clients
from hefl_tpu_torch.fl.hierarchy import (
    HierarchicalAggregator,
    ShipPolicy,
    TierCrash,
    dcn_compare_record,
)
from hefl_tpu_torch.fl.metrics import classification_metrics
from hefl_tpu_torch.fl.secure import (
    aggregate_encrypted,
    decrypt_average,
    encrypt_params,
    encrypt_params_packed,
    encrypt_stack,
    encrypt_stack_packed,
    secure_fedavg_round,
)
from hefl_tpu_torch.fl.server import AggregationServer
from hefl_tpu_torch.fl.stream import (
    DedupWindow,
    OnlineAccumulator,
    StreamEngine,
    StreamRoundMeta,
    cohort_compare_record,
    produce_uploads,
    quorum_count,
    sample_cohort,
)

__all__ = [
    "HheConfig",
    "PackingConfig",
    "StreamConfig",
    "TrainConfig",
    "DpConfig",
    "AggregationServer",
    "CrashConfig",
    "DedupWindow",
    "DeviceLost",
    "SimulatedCrash",
    "ArrivalFaults",
    "FaultConfig",
    "RoundFaults",
    "RoundMeta",
    "schedule_arrivals",
    "schedule_for_round",
    "schedule_links",
    "LinkFaults",
    "calibration_clients",
    "clip_by_global_norm",
    "dp_sanitize",
    "epsilon_spent",
    "HierarchicalAggregator",
    "ShipPolicy",
    "TierCrash",
    "dcn_compare_record",
    "OnlineAccumulator",
    "StreamEngine",
    "StreamRoundMeta",
    "quorum_count",
    "sample_cohort",
    "produce_uploads",
    "cohort_bucket",
    "cohort_compare_record",
    "local_train",
    "train_centralized",
    "fedavg_round",
    "train_clients",
    "evaluate",
    "classification_metrics",
    "encrypt_params",
    "encrypt_params_packed",
    "encrypt_stack",
    "encrypt_stack_packed",
    "aggregate_encrypted",
    "decrypt_average",
    "secure_fedavg_round",
]
