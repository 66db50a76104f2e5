"""Service feature channels: the port's copy of the service half of
``rca_tpu.features.schema``.

The engine propagates a ``[S, NUM_SERVICE_FEATURES]`` float32 matrix whose
columns are :class:`SvcF`; the layout must match the JAX package's exactly,
because both packages read the same extracted features and the same
checkpoint weights.
"""

from __future__ import annotations

import enum

import numpy as np

# the 13 log-pattern names of the feature extractor, in channel order
LOG_PATTERN_NAMES = (
    "oom_kill", "connection_refused", "permission_denied", "timeout",
    "crash_loop", "api_error", "volume_mount", "image_pull",
    "dns_resolution", "authentication", "config_error",
    "internal_server_error", "exception",
)


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
