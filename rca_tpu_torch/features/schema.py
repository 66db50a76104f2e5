"""Feature-channel schemas for the packed pod and service arrays: the port's
copy of ``rca_tpu.features.schema``.

Pod channels encode the signals the rule agents read; service channels are
the fused per-service signal vector the engine propagates.  The layouts
must match the JAX package's exactly, because both packages read the same
extracted features and the same checkpoint weights.
"""

from __future__ import annotations

import enum

import numpy as np

from rca_tpu_torch.features.logscan import LOG_PATTERN_NAMES


class PodF(enum.IntEnum):
    """Pod-level feature channels (float32)."""

    PHASE_PENDING = 0
    PHASE_RUNNING = 1
    PHASE_SUCCEEDED = 2
    PHASE_FAILED = 3
    PHASE_UNKNOWN = 4
    NOT_READY = 5          # any container not ready
    RESTARTS = 6           # raw restart count
    RESTARTS_SAT = 7       # 1 - exp(-restarts/5), saturating
    WAIT_CRASHLOOP = 8
    WAIT_IMAGEPULL = 9
    WAIT_CONFIG = 10       # CreateContainerConfigError family
    WAIT_OTHER = 11
    TERM_NONZERO = 12      # terminated (current or last) with exit code != 0
    TERM_OOM = 13          # terminated with reason OOMKilled
    INIT_FAILED = 14       # failing init container
    CPU_PCT = 15           # cpu usage / limit, 0..1+
    MEM_PCT = 16           # mem usage / limit, 0..1+
    WARN_EVENTS = 17       # warning-event count for this pod
    WARN_EVENTS_SAT = 18   # min(1, count/10)
    NO_LOGS = 19           # running but produced no logs
    LOG0 = 20              # first of the 13 log-pattern count channels


NUM_POD_FEATURES = int(PodF.LOG0) + len(LOG_PATTERN_NAMES)

POD_FEATURE_NAMES = [f.name.lower() for f in PodF if f != PodF.LOG0] + [
    f"log_{n}" for n in LOG_PATTERN_NAMES
]


class SvcF(enum.IntEnum):
    """Service-level feature channels (float32)."""

    CRASH = 0        # crash/failed-pod fraction
    ERROR_RATE = 1   # trace error rate 0..1
    LATENCY = 2      # latency degradation score 0..1
    RESTARTS = 3     # saturating restart pressure
    EVENTS = 4       # saturating warning-event pressure
    LOG_ERRORS = 5   # saturating error-log pressure
    NOT_READY = 6    # unready pod / missing endpoint fraction
    RESOURCE = 7     # cpu/mem saturation 0..1
    IMAGE = 8        # image-pull failure fraction
    CONFIG = 9       # config/secret reference failure signal
    PENDING = 10     # unschedulable/pending fraction
    OOM = 11         # OOM-kill signal
    # derived absence evidence: not-ready with no crash/restart/log
    # evidence (a root whose pod never started is silent while its
    # victims crash and log)
    SILENT = 12


# raw (observed) channels: everything before the derived block
NUM_RAW_SERVICE_FEATURES = int(SvcF.SILENT)
NUM_SERVICE_FEATURES = len(SvcF)

SERVICE_FEATURE_NAMES = [f.name.lower() for f in SvcF]


def derive_silent_channel(svc_features: np.ndarray) -> None:
    """Fill ``SvcF.SILENT`` in place from the raw channels: the not-ready
    level damped by every channel that proves the workload ran."""
    f = svc_features
    ran = (
        (1.0 - np.clip(f[:, SvcF.CRASH], 0.0, 1.0))
        * (1.0 - np.clip(f[:, SvcF.RESTARTS], 0.0, 1.0))
        * (1.0 - np.clip(f[:, SvcF.LOG_ERRORS], 0.0, 1.0))
    )
    f[:, SvcF.SILENT] = np.clip(f[:, SvcF.NOT_READY], 0.0, 1.0) * ran
