"""Log-pattern scanner: 13 named error classes (the port's copy of
``rca_tpu.features.logscan``: the native C++ scanner of
:mod:`rca_tpu_torch.native` where a toolchain exists, the regex scanner
as the fallback and the parity oracle).

Same taxonomy as the reference's log agent (reference: agents/logs_agent.py
:20-34 pattern table, :416-437 severity map, :451-477 recommendation table)
with independently-written patterns.  Patterns are compiled once; scanning
returns a count vector aligned with :data:`LOG_PATTERN_NAMES`, which the
feature extractor packs straight into the device array.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List

import numpy as np

# class name -> compiled pattern (verbose, case-handled per class)
LOG_PATTERNS: Dict[str, re.Pattern] = {
    "oom_kill": re.compile(
        r"out of memory|oomkilled|signal:\s*killed|oom[-_]?kill", re.I
    ),
    "connection_refused": re.compile(r"connection refused|ECONNREFUSED", re.I),
    "permission_denied": re.compile(r"permission denied|access denied|\bforbidden\b", re.I),
    "timeout": re.compile(r"timed?\s?-?out|ETIMEDOUT|deadline exceeded", re.I),
    "crash_loop": re.compile(r"crashloopbackoff|back-?off restarting", re.I),
    "api_error": re.compile(r"api server error|StatusCode=5\d\d"),
    "volume_mount": re.compile(r"unable to (?:attach or )?mount volumes|MountVolume\.\w+ failed", re.I),
    "image_pull": re.compile(r"ErrImagePull|ImagePullBackOff|failed to pull image", re.I),
    "dns_resolution": re.compile(r"could not resolve|DNS resolution failed|no such host", re.I),
    "authentication": re.compile(r"unauthorized|authentication fail", re.I),
    "config_error": re.compile(r"invalid configuration|configmap .*not found|secret .*not found", re.I),
    "internal_server_error": re.compile(r"internal ?server ?error|500 Internal", re.I),
    "exception": re.compile(r"\bexception\b|\berror\b|traceback|\bFATAL\b|\bCRITICAL\b|panic:?", re.I),
}

LOG_PATTERN_NAMES: List[str] = list(LOG_PATTERNS.keys())

_SEVERITY = {
    **{k: "high" for k in ("oom_kill", "crash_loop", "image_pull")},
    **{k: "medium" for k in ("connection_refused", "timeout", "volume_mount",
                             "dns_resolution", "internal_server_error")},
    **{k: "low" for k in ("permission_denied", "authentication", "config_error")},
}

_RECOMMENDATIONS = {
    "oom_kill": "Raise the container memory limit or reduce the application's memory footprint",
    "connection_refused": "Verify the target service is running, its endpoints are populated, and no network policy blocks it",
    "permission_denied": "Review RBAC bindings, the pod's service account, and security contexts",
    "timeout": "Look for network degradation, raise timeout budgets, or speed up the slow dependency",
    "crash_loop": "Read the container's previous logs to find the crash cause and fix the application",
    "api_error": "Inspect Kubernetes API-server health and the client's configuration",
    "volume_mount": "Check PVC binding status, the storage class, and volume permissions",
    "image_pull": "Confirm the image tag exists, pull credentials are valid, and the registry is reachable",
    "dns_resolution": "Check cluster DNS (CoreDNS) health and any network policies blocking port 53",
    "authentication": "Verify credentials, token expiry, and auth configuration",
    "config_error": "Ensure every referenced ConfigMap and Secret exists with the expected keys",
    "internal_server_error": "Investigate the upstream service returning 5xx responses",
    "exception": "Debug the application stack trace to resolve the underlying exception",
}


def pattern_severity(name: str) -> str:
    return _SEVERITY.get(name, "info")


def pattern_recommendation(name: str) -> str:
    return _RECOMMENDATIONS.get(
        name, "Inspect the surrounding log context to identify the root cause"
    )


def scan_text_python(text: str) -> np.ndarray:
    """Pure-Python reference scanner (the parity oracle for the C++
    path)."""
    counts = np.zeros(len(LOG_PATTERN_NAMES), dtype=np.int32)
    if not text:
        return counts
    for i, name in enumerate(LOG_PATTERN_NAMES):
        counts[i] = len(LOG_PATTERNS[name].findall(text))
    return counts


def scan_text(text: str) -> np.ndarray:
    """Count matches of every pattern class in one log text → int32 [13].

    Uses the native C++ scanner (:mod:`rca_tpu_torch.native`) when a
    toolchain is available, falling back to the Python regex oracle
    (identical counts, enforced by tests/test_torch_native.py)."""
    if not text:
        return np.zeros(len(LOG_PATTERN_NAMES), dtype=np.int32)
    from rca_tpu_torch.native import scan_text_native

    counts = scan_text_native(text)
    if counts is not None:
        return counts
    return scan_text_python(text)


@functools.lru_cache(maxsize=4096)
def _scan_text_cached(text: str) -> bytes:
    """Memoized scan keyed by log content: the columnar row encoder
    re-derives a pod's counts on every journaled log touch, and unchanged
    tails would otherwise re-run the scan.  Returns immutable bytes so
    cached entries cannot be mutated through a returned array."""
    return scan_text(text).tobytes()


def scan_text_cached(text: str) -> np.ndarray:
    """Content-memoized :func:`scan_text` (same counts, enforced by the
    parity tests); the cache is process-wide and bounded."""
    return np.frombuffer(
        _scan_text_cached(text), dtype=np.int32
    ).copy()


def scan_pod_logs(logs_by_container: Dict[str, str]) -> np.ndarray:
    """Sum pattern counts across a pod's containers → int32 [13]."""
    counts = np.zeros(len(LOG_PATTERN_NAMES), dtype=np.int32)
    for text in logs_by_container.values():
        counts += scan_text(text)
    return counts
