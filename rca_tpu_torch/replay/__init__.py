"""Flight recorder: deterministic incident record and replay, with the
divergence bisect (the port's copy of ``rca_tpu.replay``; either package
reads the other's recordings).

- :mod:`rca_tpu_torch.replay.format`    CRC-framed, chunked,
  schema-versioned on-disk log (truncated tails and corrupt frames stop
  cleanly);
- :mod:`rca_tpu_torch.replay.recorder`  the :class:`Recorder` that
  ``LiveStreamingSession``, ``ServeLoop`` and ``ServePool`` write
  through: per-tick client calls, rankings, feature digests, the env
  fingerprint;
- :mod:`rca_tpu_torch.replay.source`    :class:`ReplaySource`, a cluster
  client answered entirely from a recording (errors re-raise);
- :mod:`rca_tpu_torch.replay.replayer`  replay, seek, bisect, mint and
  the serve replay, behind ``python -m rca_tpu_torch replay``.
"""

from rca_tpu_torch.replay.format import (
    ReadStatus,
    ReplayFormatError,
    SCHEMA_VERSION,
    decode_array,
    digest_array,
    digest_obj,
    encode_array,
    read_frames,
)
from rca_tpu_torch.replay.recorder import (
    FEATURES_FULL_CAP,
    Recorder,
    RecordingClusterClient,
    env_fingerprint,
)
from rca_tpu_torch.replay.replayer import (
    Recording,
    bisect_divergence,
    load_recording,
    mint_recording,
    replay,
    replay_serve,
    replay_stream,
)
from rca_tpu_torch.replay.source import (
    ReplayMismatch,
    ReplaySource,
    ReplayedFault,
)

__all__ = [
    "SCHEMA_VERSION",
    "FEATURES_FULL_CAP",
    "ReadStatus",
    "ReplayFormatError",
    "Recorder",
    "Recording",
    "RecordingClusterClient",
    "ReplayMismatch",
    "ReplaySource",
    "ReplayedFault",
    "bisect_divergence",
    "decode_array",
    "digest_array",
    "digest_obj",
    "encode_array",
    "env_fingerprint",
    "load_recording",
    "mint_recording",
    "read_frames",
    "replay",
    "replay_serve",
    "replay_stream",
]
