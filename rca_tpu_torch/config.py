"""The engine's configuration: the subset of ``rca_tpu.config`` that the
one-shot engine reads, kept as the port's own copy so that the port loads
nothing of the JAX package.

Copied semantics: :class:`RCAConfig`'s engine knobs, the shape-bucket rule
:func:`bucket_for`, the free-form env accessor :func:`env_raw`
(``RCA_WEIGHTS``), the checked accessors :func:`env_str` (``RCA_BACKEND``)
and :func:`env_int`, :func:`explain_enabled` (``RCA_EXPLAIN``) with its
two sizes :func:`explain_paths` / :func:`explain_topm`, the kernel
registry's knobs: :func:`kernel_cache_path` (``RCA_KERNEL_CACHE``),
:func:`forced_kernel` (``RCA_KERNEL``) and the scans' edge layout
:func:`edge_layout` (``RCA_EDGE_LAYOUT``), the resident sessions'
:func:`resident_enabled` (``RCA_RESIDENT``) and :func:`resident_cache_cap`
(``RCA_RESIDENT_CACHE``), the live session's :func:`pipeline_depth_from_env`
(``RCA_PIPELINE_DEPTH``), tracing (``RCA_TRACE``, ``RCA_TRACE_BUFFER``),
kernelscope (``RCA_KERNELSCOPE``, ``RCA_MEM_SAMPLE_EVERY``), the
correlate stage's device trace :func:`device_profile_dir`
(``RCA_TORCH_PROFILE``),
:func:`compile_cache_status`, which in the port describes the kernel build
directory, and the capture layer's knobs: :func:`columnar_enabled`
(``RCA_COLUMNAR``), the live columnar feed's :func:`ingest_topo_every`
(``RCA_INGEST_TOPO_EVERY``) and :func:`ingest_log_fetch`
(``RCA_INGEST_LOGS``), and the native host scanners'
:func:`native_scan_mode` (``RCA_NATIVE_SCAN``),
:func:`native_sanitize_mode` (``RCA_NATIVE_SANITIZE``) and
:func:`native_cache_dir` (``RCA_NATIVE_CACHE``), and the serving
scheduler's: :class:`ServeConfig` (``RCA_SERVE_MAX_BATCH``,
``RCA_SERVE_MAX_WAIT_US``, ``RCA_SERVE_QUEUE_CAP``, ``RCA_SERVE_REPLICAS``,
``RCA_SERVE_STEAL``, ``RCA_SERVE_REPLICA_MIX``) with
:func:`parse_replica_mix`, :func:`serve_graph_cache_cap`
(``RCA_SERVE_GRAPH_CACHE``) and :func:`slo_ms` (``RCA_SLO_MS``), read
through the float accessor :func:`env_float`, the investigation
layer's :func:`log_dir` (``RCA_LOG_DIR``), and the gateway's and the
canary's: :func:`gateway_port`, :func:`gateway_max_body`,
:func:`canary_sample_rate`, :func:`gateway_tls_files`,
:func:`gateway_tls_client_ca`, :func:`gateway_tokens` and
:func:`gateway_tenant_rps`, and the cross-process plane's:
:func:`fed_workers`, :func:`fed_heartbeat_s`, :func:`fed_lease_misses`,
:func:`fed_window`, the autoscaler's :func:`fed_scale_min`,
:func:`fed_scale_max`, :func:`fed_scale_cooldown_s` and
:func:`fed_scale_interval_s` (``RCA_FED_*``), :func:`ingest_tick_s`
(``RCA_INGEST_TICK_S``), :func:`env_int_opt` and :func:`environ_copy`,
and the runtime lock sanitizer's switch :func:`rsan_enabled`
(``RCA_RSAN``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """A free-form env value (path): pass-through with no validation
    beyond centralizing the read.  None when unset."""
    value = os.environ.get(name)
    return default if value is None else value


def env_str(name: str, default: str = "", *, choices=None,
            lower: bool = False) -> str:
    """A string env knob; empty/unset means ``default`` (which is NOT
    checked against ``choices`` — an unset knob is always legal)."""
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    if lower:
        raw = raw.lower()
    if choices is not None and raw not in choices:
        raise ValueError(
            f"{name}={raw!r}: expected one of {tuple(choices)}"
        )
    return raw


def env_int(name: str, default: int, lo: int, hi: int) -> int:
    """A range-checked integer env knob; empty/unset means ``default``."""
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer in [{lo}, {hi}]")
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value}: out of range [{lo}, {hi}]")
    return value


def env_float(name: str, default: float, lo: float, hi: float) -> float:
    """A range-checked float env knob; empty/unset means ``default``."""
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: expected a number in [{lo}, {hi}]"
        )
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value}: out of range [{lo}, {hi}]")
    return value


def _flag_on(name: str, default: str) -> bool:
    return env_str(name, default, choices=("0", "1", "on", "off"),
                   lower=True) in ("1", "on")


def explain_enabled() -> bool:
    """``RCA_EXPLAIN``: attach the attribution block to engine rankings."""
    return _flag_on("RCA_EXPLAIN", "0")


def explain_paths() -> int:
    """``RCA_EXPLAIN_PATHS``: blame-path hop cap per candidate."""
    return env_int("RCA_EXPLAIN_PATHS", 4, 1, 16)


def explain_topm() -> int:
    """``RCA_EXPLAIN_TOPM``: counterfactual evidence rows per sweep."""
    return env_int("RCA_EXPLAIN_TOPM", 8, 1, 64)


#: the kernel registry's rows: ``torch`` (plain PyTorch ops, the default),
#: ``kernels`` (the hand-written CUDA kernels), ``quantized`` (bf16
#: evidence, int8 messages) and ``doubling`` (log-depth operator doubling)
KERNELS = ("torch", "kernels", "quantized", "doubling")


def kernel_cache_path(platform: str) -> Optional[str]:
    """``RCA_KERNEL_CACHE``: the registry's cache of timed winners.
    Unset/empty = ``kernel_cache.<platform>.json`` beside the built kernels
    in the port's build directory (a CPU host and a CUDA host never
    overwrite each other's rows); ``0``/``off``/``none`` = no cache
    (None)."""
    from rca_tpu_torch.kernels.build import BUILD_DIR

    raw = (env_raw("RCA_KERNEL_CACHE") or "").strip()
    if not raw:
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "-"
                       for ch in platform) or "cpu"
        return str(BUILD_DIR / f"kernel_cache.{safe}.json")
    if raw.lower() in ("0", "off", "none"):
        return None
    return raw


def forced_kernel() -> Optional[str]:
    """``RCA_KERNEL``: the registry row every shape engages (a
    :data:`KERNELS` member), or None to let the registry decide."""
    return env_str("RCA_KERNEL", "", choices=("",) + KERNELS,
                   lower=True) or None


def log_dir() -> str:
    """``RCA_LOG_DIR``: where investigations, evidence files and prompt
    logs are written (default ``logs``, relative to the working
    directory)."""
    return (env_raw("RCA_LOG_DIR") or "").strip() or "logs"


#: the propagation's edge layouts (``RCA_EDGE_LAYOUT``)
EDGE_LAYOUTS = ("hybrid", "coo", "ell")


def edge_layout() -> str:
    """``RCA_EDGE_LAYOUT``, the edge layout of the propagation scans:

    - ``hybrid`` (default): the registry row's own steps (the seg-step
      kernels on the ``kernels`` row, the narrow up-table and the sorted
      segment sum on the ``torch`` row);
    - ``coo``: the up-steps a scatter-max over the COO edges, the
      down-steps the sorted segment sum, plain ops on every row (the
      front still runs the row's own);
    - ``ell``: one-shot analyses over width-capped gather tables with a
      short overflow list per direction (``engine/ell.py``); every other
      surface runs the ``coo`` form.

    Empty means ``hybrid``; any other value raises."""
    return env_str("RCA_EDGE_LAYOUT", "hybrid", choices=EDGE_LAYOUTS,
                   lower=True)


def resident_enabled() -> bool:
    """``RCA_RESIDENT``: device-resident one-shot analyze sessions (default
    on; 0 restages the full padded matrix on every call)."""
    return _flag_on("RCA_RESIDENT", "1")


def resident_cache_cap() -> int:
    """``RCA_RESIDENT_CACHE``: resident sessions kept per engine (LRU)."""
    return env_int("RCA_RESIDENT_CACHE", 8, 1, 1024)


def pipeline_depth_from_env(default: int = 1) -> int:
    """``RCA_PIPELINE_DEPTH`` as a validated int (>= 1); empty/unset means
    the caller's default.  A malformed value fails loudly."""
    raw = (os.environ.get("RCA_PIPELINE_DEPTH") or "").strip()
    if not raw:
        return default
    try:
        depth = int(raw)
    except ValueError:
        raise ValueError(
            f"RCA_PIPELINE_DEPTH={raw!r}: expected a positive integer"
        )
    if depth < 1:
        raise ValueError(
            f"RCA_PIPELINE_DEPTH={depth}: depth counts this tick too, so "
            "it must be >= 1 (1 = serial)"
        )
    return depth


def chaos_seed() -> int:
    """``RCA_CHAOS_SEED``: the chaos soak's fault-schedule seed when the
    ``chaos`` command gets no ``--seed`` (default 7)."""
    return env_int("RCA_CHAOS_SEED", 7, 0, 2**31 - 1)


def trace_enabled() -> bool:
    """``RCA_TRACE``: span-based tracing (default off: the null tracer)."""
    return _flag_on("RCA_TRACE", "0")


def trace_buffer_cap() -> int:
    """``RCA_TRACE_BUFFER``: ring-buffer span capacity."""
    return env_int("RCA_TRACE_BUFFER", 8192, 64, 1_000_000)


def kernelscope_enabled() -> bool:
    """``RCA_KERNELSCOPE``: the recompile monitor and the device-memory
    accountant of the live session's health record (default on)."""
    return _flag_on("RCA_KERNELSCOPE", "1")


def device_profile_dir() -> Optional[str]:
    """``RCA_TORCH_PROFILE=<dir>``: a ``torch.profiler`` trace of each
    comprehensive analysis's correlate stage under ``<dir>/correlate``
    (unset: no trace)."""
    return env_raw("RCA_TORCH_PROFILE") or None


def memory_sample_every() -> int:
    """``RCA_MEM_SAMPLE_EVERY``: ticks between device-memory samples."""
    return env_int("RCA_MEM_SAMPLE_EVERY", 10, 1, 100_000)


def compile_cache_status() -> dict:
    """The port's compile cache: the kernel build directory, where the
    built library (named by a hash of its sources) and the registry's
    timed rows persist across processes.  Always enabled; ``entries``
    counts its files now, so a caller sampling it before and after a
    session's first tick sees what that session had to build."""
    from rca_tpu_torch.kernels.build import BUILD_DIR

    try:
        entries = sum(1 for e in os.scandir(BUILD_DIR) if e.is_file())
    except OSError:
        entries = 0
    return {"enabled": True, "dir": str(BUILD_DIR), "entries": entries}


def columnar_enabled() -> bool:
    """``RCA_COLUMNAR``: columnar world-state capture.  When a cluster
    client exposes ``get_columnar`` (the mock world and the live client's
    feed do), snapshot capture reads the incrementally-maintained columnar
    tables instead of re-sanitizing and re-scanning every object per
    sweep, and feature extraction becomes a vectorized assembly over the
    tables' columns — bit-identical to the per-object dict path.  Default
    on; 0 restores the dict scans."""
    return env_str(
        "RCA_COLUMNAR", "1", choices=("0", "1", "on", "off"), lower=True,
    ) in ("1", "on")


def rsan_enabled() -> bool:
    """``RCA_RSAN``: route the :mod:`rca_tpu_torch.util.threads`
    constructors through the runtime lock sanitizer
    (:mod:`rca_tpu_torch.analysis.concurrency.rsan`) so lock acquisition
    orders and shared-state access pairs are recorded for the static
    model's cross-check.  Default off — bare primitives, zero per-acquire
    cost."""
    return env_str(
        "RCA_RSAN", "0", choices=("0", "1", "on", "off"), lower=True,
    ) in ("1", "on")


def ingest_topo_every() -> int:
    """``RCA_INGEST_TOPO_EVERY``: topology re-list cadence (sweeps)."""
    return env_int("RCA_INGEST_TOPO_EVERY", 1, 0, 100_000)


def ingest_log_fetch() -> bool:
    """``RCA_INGEST_LOGS``: fetch container logs into the live feed."""
    return env_str(
        "RCA_INGEST_LOGS", "1", choices=("0", "1", "on", "off"),
        lower=True,
    ) in ("1", "on")


def native_scan_mode() -> str:
    """``RCA_NATIVE_SCAN``: the C++ log scanner (``auto``, the default,
    builds it where a toolchain exists; ``0`` keeps the regex scanner)."""
    return env_str("RCA_NATIVE_SCAN", "auto", choices=("auto", "0", "1"))


def native_sanitize_mode() -> str:
    """``RCA_NATIVE_SANITIZE``: the C sanitize extension (``auto`` /
    ``0`` / ``1``, as :func:`native_scan_mode`)."""
    return env_str("RCA_NATIVE_SANITIZE", "auto",
                   choices=("auto", "0", "1"))


def native_cache_dir() -> Optional[str]:
    """``RCA_NATIVE_CACHE``: where the native scanners are built (unset =
    the port's user-private default, ``~/.cache/rca_tpu_torch``)."""
    return env_raw("RCA_NATIVE_CACHE")


def serve_graph_cache_cap() -> int:
    """``RCA_SERVE_GRAPH_CACHE``: prepared graphs the dispatcher pins."""
    return env_int("RCA_SERVE_GRAPH_CACHE", 32, 1, 4096)


def serve_steal_enabled() -> bool:
    """``RCA_SERVE_STEAL``: work-stealing rebalance in the serve pool."""
    return _flag_on("RCA_SERVE_STEAL", "1")


def slo_ms() -> float:
    """``RCA_SLO_MS``: the per-request latency SLO target (ms)."""
    return env_float("RCA_SLO_MS", 500.0, 1.0, 600_000.0)


#: the serving scheduler's integer knobs and their ranges:
#: ``RCA_SERVE_MAX_BATCH`` requests coalesced per device dispatch (a full
#: batch never waits; default 16), ``RCA_SERVE_MAX_WAIT_US`` the longest a
#: request is held for batchmates while the device is busy (default 2000;
#: an idle engine never waits), ``RCA_SERVE_QUEUE_CAP`` the admission cap
#: (a submit against a full queue is answered ``queue_full``; default 256),
#: ``RCA_SERVE_REPLICAS`` the engine replicas behind the shared queue
#: (default 1: the single ``ServeLoop``)
_SERVE_ENV_RANGES = {
    "RCA_SERVE_MAX_BATCH": (1, 4096),
    "RCA_SERVE_MAX_WAIT_US": (0, 60_000_000),
    "RCA_SERVE_QUEUE_CAP": (1, 1_000_000),
    "RCA_SERVE_REPLICAS": (1, 64),
}

#: replica kinds a serve-pool mix may name
REPLICA_KINDS = ("dense", "sharded")

_MIX_ENTRY = re.compile(r"(dense|sharded)(?:@(\d+))?(?::(\d+))?")


def parse_replica_mix(
    spec: str, default_replicas: int = 1,
) -> Tuple[Tuple[str, Optional[int]], ...]:
    """``RCA_SERVE_REPLICA_MIX`` → ``((kind, group_size|None), ...)``.

    Syntax: comma-separated ``kind[@group_size][:count]`` entries, e.g.
    ``"dense:2,sharded@4:2"`` = two dense replicas (one device each) plus
    two sharded replicas spanning four devices each.  ``group_size``
    defaults per kind at pool construction (dense → 1, sharded → an equal
    share of the visible devices).  An empty spec means
    ``default_replicas`` dense replicas.  A malformed spec fails loudly."""
    spec = (spec or "").strip().lower()
    if not spec:
        return tuple(("dense", None) for _ in range(default_replicas))
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = _MIX_ENTRY.fullmatch(part)
        if m is None:
            raise ValueError(
                f"RCA_SERVE_REPLICA_MIX entry {part!r}: expected "
                "'kind[@group_size][:count]' with kind in "
                f"{REPLICA_KINDS}"
            )
        kind, group, count = m.group(1), m.group(2), m.group(3)
        count = int(count) if count else 1
        group_size = int(group) if group else None
        if not 1 <= count <= 64:
            raise ValueError(
                f"RCA_SERVE_REPLICA_MIX entry {part!r}: count {count} "
                "out of range [1, 64]"
            )
        if group_size is not None and not 1 <= group_size <= 4096:
            raise ValueError(
                f"RCA_SERVE_REPLICA_MIX entry {part!r}: group size "
                f"{group_size} out of range [1, 4096]"
            )
        out.extend((kind, group_size) for _ in range(count))
    if not 1 <= len(out) <= 64:
        raise ValueError(
            f"RCA_SERVE_REPLICA_MIX={spec!r}: {len(out)} replicas out "
            "of range [1, 64]"
        )
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Typed serving-scheduler knobs (``rca_tpu_torch.serve``)."""

    max_batch: int = 16      # RCA_SERVE_MAX_BATCH
    max_wait_us: int = 2000  # RCA_SERVE_MAX_WAIT_US
    queue_cap: int = 256     # RCA_SERVE_QUEUE_CAP
    replicas: int = 1        # RCA_SERVE_REPLICAS (serve pool width)
    steal: bool = True       # RCA_SERVE_STEAL (rebalance on death/open)
    replica_mix: str = ""    # RCA_SERVE_REPLICA_MIX ("" = all dense)

    def __post_init__(self):
        # the env parse's ranges, so a directly-constructed config cannot
        # carry a value the env path would reject
        for name, value in (
            ("RCA_SERVE_MAX_BATCH", self.max_batch),
            ("RCA_SERVE_MAX_WAIT_US", self.max_wait_us),
            ("RCA_SERVE_QUEUE_CAP", self.queue_cap),
            ("RCA_SERVE_REPLICAS", self.replicas),
        ):
            lo, hi = _SERVE_ENV_RANGES[name]
            if not lo <= int(value) <= hi:
                raise ValueError(
                    f"{name.lower().removeprefix('rca_serve_')}={value}: "
                    f"out of range [{lo}, {hi}]"
                )
        # a malformed mix fails at construction, not at pool start
        parse_replica_mix(self.replica_mix, self.replicas)

    def replica_specs(self) -> Tuple[Tuple[str, Optional[int]], ...]:
        """The resolved replica set: the parsed mix when one is given (its
        length then DEFINES the replica count), else ``replicas`` dense
        entries."""
        return parse_replica_mix(self.replica_mix, self.replicas)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        env = {
            "max_batch": _serve_env_int("RCA_SERVE_MAX_BATCH", 16),
            "max_wait_us": _serve_env_int("RCA_SERVE_MAX_WAIT_US", 2000),
            "queue_cap": _serve_env_int("RCA_SERVE_QUEUE_CAP", 256),
            "replicas": _serve_env_int("RCA_SERVE_REPLICAS", 1),
            "steal": serve_steal_enabled(),
            "replica_mix": env_str("RCA_SERVE_REPLICA_MIX", ""),
        }
        env.update(overrides)
        return cls(**env)


def _serve_env_int(name: str, default: int) -> int:
    """One ``RCA_SERVE_*`` integer knob, range-checked."""
    return env_int(name, default, *_SERVE_ENV_RANGES[name])


# -- the gateway and the canary ------------------------------------------------
# the wire front door (rca_tpu_torch/gateway) and the replay canary, each
# knob checked here so a typo'd value fails loudly:
#
#   RCA_GATEWAY_PORT        [0, 65535]  default listen port of `serve
#                           --listen` when the spec omits one (default
#                           8321; 0 = an ephemeral port, printed)
#   RCA_GATEWAY_MAX_BODY    [1024, 1 GiB]  largest request body accepted,
#                           bytes (default 8 MiB; larger bodies get 413
#                           before a byte of them is read)
#   RCA_CANARY_SAMPLE_RATE  [0.0, 1.0]  probability `canary` records a
#                           sampling round (default 1.0)
#   RCA_GATEWAY_TLS_CERT /  PEM cert chain and key: both set wrap the
#   RCA_GATEWAY_TLS_KEY     listener in TLS; one without the other fails
#   RCA_GATEWAY_TLS_CLIENT_CA  PEM CA bundle for mutual TLS (needs the
#                           pair above): the listener demands and verifies
#                           a client certificate at the handshake
#   RCA_GATEWAY_TOKENS      bearer tokens, ``token:tenant[:expires_unix]``
#                           comma-separated: every route but /healthz then
#                           needs ``Authorization: Bearer``, checked before
#                           the body is read, and the token's tenant binds
#                           the request (another X-RCA-Tenant is a 403)
#   RCA_GATEWAY_TENANT_RPS  [0, 1e6]  per-tenant token bucket at the wire,
#                           requests per second (0 = off, the default)


def gateway_port() -> int:
    """``RCA_GATEWAY_PORT``: the gateway's default listen port."""
    return env_int("RCA_GATEWAY_PORT", 8321, 0, 65535)


def gateway_max_body() -> int:
    """``RCA_GATEWAY_MAX_BODY``: the request-body byte cap (413 beyond)."""
    return env_int("RCA_GATEWAY_MAX_BODY", 8 * 1024 * 1024, 1024, 1 << 30)


def canary_sample_rate() -> float:
    """``RCA_CANARY_SAMPLE_RATE``: the per-round recording probability."""
    return env_float("RCA_CANARY_SAMPLE_RATE", 1.0, 0.0, 1.0)


def gateway_tls_files() -> Optional[Tuple[str, str]]:
    """``RCA_GATEWAY_TLS_CERT`` / ``RCA_GATEWAY_TLS_KEY`` as a checked
    pair: both set → ``(cert, key)``; neither → None (plaintext); one
    without the other raises."""
    cert = (env_raw("RCA_GATEWAY_TLS_CERT") or "").strip()
    key = (env_raw("RCA_GATEWAY_TLS_KEY") or "").strip()
    if not cert and not key:
        return None
    if not (cert and key):
        raise ValueError(
            "RCA_GATEWAY_TLS_CERT and RCA_GATEWAY_TLS_KEY must be set "
            "together (a half-configured TLS gateway would silently "
            "serve plaintext)"
        )
    return cert, key


def gateway_tls_client_ca() -> Optional[str]:
    """``RCA_GATEWAY_TLS_CLIENT_CA``: the PEM CA bundle that makes the TLS
    gateway mutual; set without the cert/key pair it raises."""
    ca = (env_raw("RCA_GATEWAY_TLS_CLIENT_CA") or "").strip()
    if not ca:
        return None
    if gateway_tls_files() is None:
        raise ValueError(
            "RCA_GATEWAY_TLS_CLIENT_CA requires RCA_GATEWAY_TLS_CERT/"
            "RCA_GATEWAY_TLS_KEY (client-cert verification needs a TLS "
            "listener to verify on)"
        )
    return ca


def parse_gateway_tokens(spec: str) -> Dict[str, Tuple[str, Optional[float]]]:
    """``RCA_GATEWAY_TOKENS`` → ``{token: (tenant, expires_unix | None)}``.

    Comma-separated ``token:tenant[:expires_unix]``; tokens and tenants
    non-empty, tokens unique.  A malformed spec raises: a typo'd token
    list must not run the gateway open."""
    out: Dict[str, Tuple[str, Optional[float]]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (2, 3) or not fields[0] or not fields[1]:
            raise ValueError(
                f"RCA_GATEWAY_TOKENS entry {part!r}: expected "
                "'token:tenant[:expires_unix]'"
            )
        expires: Optional[float] = None
        if len(fields) == 3:
            try:
                expires = float(fields[2])
            except ValueError:
                raise ValueError(
                    f"RCA_GATEWAY_TOKENS entry {part!r}: expiry "
                    f"{fields[2]!r} is not a number"
                )
        if fields[0] in out:
            raise ValueError(
                f"RCA_GATEWAY_TOKENS: duplicate token {fields[0][:4]}…"
            )
        out[fields[0]] = (fields[1], expires)
    return out


def gateway_tokens() -> Dict[str, Tuple[str, Optional[float]]]:
    """``RCA_GATEWAY_TOKENS`` parsed; an empty dict turns authn off."""
    return parse_gateway_tokens(env_raw("RCA_GATEWAY_TOKENS") or "")


def gateway_tenant_rps() -> float:
    """``RCA_GATEWAY_TENANT_RPS``: the per-tenant token-bucket rate at the
    gateway, requests per second ([0, 1e6]; 0 = off, the default).  Each
    tenant gets its own bucket with one second's burst, and a request over
    it gets 429 with ``Retry-After`` without touching the serve queue."""
    return env_float("RCA_GATEWAY_TENANT_RPS", 0.0, 0.0, 1e6)


# -- the cross-process plane ---------------------------------------------------
# the federation's knobs keep the reference's names, ranges and defaults
# (the autoscaler's: RCA_FED_SCALE_MIN [1, 64] default 1, RCA_FED_SCALE_MAX
# [1, 64] default 8, RCA_FED_SCALE_COOLDOWN_S [0.05, 600] default 10.0,
# RCA_FED_SCALE_INTERVAL_S [0.01, 60] default 1.0);
# the bootstrap reads torchrun's WORLD_SIZE / RANK / LOCAL_RANK through
# env_int_opt (unset means "not given", 0 is a real rank)


def env_int_opt(name: str, lo: int, hi: int) -> Optional[int]:
    """Like :func:`env_int` but unset/empty means None (knobs where 0 is
    a meaningful value and absence is a signal of its own)."""
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return None
    return env_int(name, 0, lo, hi)


def environ_copy() -> Dict[str, str]:
    """A snapshot of the FULL environment, for spawning child processes
    (the federation's workers inherit the parent's ``RCA_*`` knobs and
    overlay their own)."""
    return dict(os.environ)


def fed_workers() -> int:
    """``RCA_FED_WORKERS``: worker processes under the federation."""
    return env_int("RCA_FED_WORKERS", 2, 1, 64)


def fed_heartbeat_s() -> float:
    """``RCA_FED_HEARTBEAT_S``: worker heartbeat interval (seconds)."""
    return env_float("RCA_FED_HEARTBEAT_S", 0.5, 0.01, 60.0)


def fed_lease_misses() -> int:
    """``RCA_FED_LEASE_MISSES``: missed heartbeats before lease expiry."""
    return env_int("RCA_FED_LEASE_MISSES", 3, 2, 100)


def fed_window() -> int:
    """``RCA_FED_WINDOW``: per-worker outstanding-request window."""
    return env_int("RCA_FED_WINDOW", 64, 1, 4096)


def fed_scale_min() -> int:
    """``RCA_FED_SCALE_MIN``: autoscaler fleet floor."""
    return env_int("RCA_FED_SCALE_MIN", 1, 1, 64)


def fed_scale_max() -> int:
    """``RCA_FED_SCALE_MAX``: autoscaler fleet ceiling."""
    return env_int("RCA_FED_SCALE_MAX", 8, 1, 64)


def fed_scale_cooldown_s() -> float:
    """``RCA_FED_SCALE_COOLDOWN_S``: quiet period after a scale action."""
    return env_float("RCA_FED_SCALE_COOLDOWN_S", 10.0, 0.05, 600.0)


def fed_scale_interval_s() -> float:
    """``RCA_FED_SCALE_INTERVAL_S``: controller sweep cadence (seconds)."""
    return env_float("RCA_FED_SCALE_INTERVAL_S", 1.0, 0.01, 60.0)


def ingest_tick_s() -> float:
    """``RCA_INGEST_TICK_S``: ingest-worker capture cadence (seconds)."""
    return env_float("RCA_INGEST_TICK_S", 0.05, 0.0, 60.0)


@dataclasses.dataclass(frozen=True)
class RCAConfig:
    # propagation iterations (graph-diameter cap) and ranked-output length
    propagation_steps: int = 8
    top_k_root_causes: int = 5
    # Shape-bucket tiers for padded node AND edge counts: explicit
    # power-of-two tiers up to 4096; above, sizes round up to 8 sub-tiers
    # per octave (bucket_for), capping padding waste at 12.5%.
    shape_buckets: tuple = (64, 128, 256, 512, 1024, 2048, 4096)


def bucket_for(n: int, buckets) -> int:
    """Smallest shape bucket >= n.

    Within ``buckets``: the explicit tier list.  Beyond it: round up to the
    next multiple of an eighth of n's power-of-two octave."""
    for b in buckets:
        if n <= b:
            return b
    n = int(n)
    quantum = max(1 << (n.bit_length() - 1), 8) // 8
    return ((n + quantum - 1) // quantum) * quantum
