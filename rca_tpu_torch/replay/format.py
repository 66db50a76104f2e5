"""Flight-recorder log format: CRC-framed, chunked, schema-versioned.

The port's copy of ``rca_tpu.replay.format``, byte for byte the same
layout: either package reads the other's recordings.

A recording is either a **directory** of chunk files (the recorder's
append path — chunks rotate at a byte budget and each rotation fsyncs, so
a crash loses at most the unsynced tail of one chunk) or a **single file**
(the minted corpus form, ``replay --mint``).  Either way the byte
layout is the same:

- every chunk starts with an 8-byte magic ``RCAREC<version>\\n`` — a file
  with a foreign magic is not a recording, and a matching magic with a
  different version byte is a :class:`ReplayFormatError` (schema-version
  mismatch is an ERROR, never a silent partial read);
- frames follow back to back: ``[u32 payload_len][u32 crc32][u8 flags]``
  then the payload — UTF-8 JSON, zlib-compressed when flags bit 0 is set
  (the CRC covers the stored, possibly-compressed bytes);
- a **truncated tail** (EOF inside a frame — the writer crashed mid
  append) or a **corrupt frame** (CRC mismatch — bit rot, torn write)
  stops the read CLEANLY at the last good frame: the reader reports
  ``truncated``/``corrupt`` in its status instead of raising, because a
  crashed recording is still evidence for every tick it completed.

Frame payloads are JSON objects tagged by ``kind`` (``header`` / ``call``
/ ``tick`` / ``serve`` / ``end``); the recorder and replayer own those
schemas.  ``json.dumps`` round-trips NaN and
Infinity (Python's non-strict JSON), which matters: chaos-injected
``nan_metrics`` payloads must replay poisoned, not cleaned.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

SCHEMA_VERSION = 1
_MAGIC_PREFIX = b"RCAREC"
MAGIC = _MAGIC_PREFIX + bytes([SCHEMA_VERSION]) + b"\n"
_FRAME_HEAD = struct.Struct("<IIB")  # payload_len, crc32, flags

FLAG_ZLIB = 0x01

#: rotate the active chunk once it exceeds this many bytes (recorder dirs)
DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024
#: compress call/tick payloads larger than this (small frames stay raw —
#: zlib overhead beats the saving under ~1 KiB)
COMPRESS_OVER_BYTES = 1024

CHUNK_GLOB_PREFIX = "chunk-"
CHUNK_SUFFIX = ".rcr"


class ReplayFormatError(ValueError):
    """The bytes are not a (supported) recording: foreign magic, or a
    schema version this build does not read."""


def make_call_key(args: tuple, kwargs: dict) -> str:
    """Stable identity of one client call's arguments — the replay lookup
    key.  Positional and keyword spellings are deliberately NOT unified:
    the session's call sites are the same code at record and replay time,
    so the spelling is part of the determinism being checked."""
    return json.dumps(
        [list(args), sorted(kwargs.items())], sort_keys=True, default=str
    )


def digest_obj(obj: Any) -> str:
    """Stable content digest of a JSON-able object (rankings, changes)."""
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def digest_array(arr: np.ndarray) -> str:
    """Content digest of an ndarray (shape + dtype + raw bytes)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    """ndarray -> JSON-able {b64, dtype, shape} (raw little-endian bytes;
    recordings are not meant to cross endianness, the env fingerprint in
    the header says where they came from)."""
    a = np.ascontiguousarray(arr)
    return {
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["b64"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"]).copy()


def digest_array_crc(arr: np.ndarray) -> str:
    """Content digest of an ndarray in ONE vectorized CRC pass (shape +
    dtype + raw bytes through crc32).  ~10x cheaper per tick than the
    sha1 digest for the recorder's per-tick feature stamp; sha1
    (:func:`digest_array`) remains for old recordings — the tick frame's
    ``digest_algo`` field says which one sealed it."""
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(f"{a.shape}{a.dtype}".encode())
    crc = zlib.crc32(a.tobytes(), crc)
    return f"{crc:08x}"


_ND_TAG = "__ndarray__"


def jsonify_ndarrays(obj: Any) -> Any:
    """Deep-copy ``obj`` with every ndarray replaced by a tagged
    :func:`encode_array` dict — how a columnar payload (raw numpy columns
    in process) becomes a JSON-able ``coldiff`` frame.  Tuples become
    lists (JSON would anyway); scalars/str/dict keys pass through."""
    if isinstance(obj, np.ndarray):
        return {_ND_TAG: encode_array(obj)}
    if isinstance(obj, dict):
        return {k: jsonify_ndarrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify_ndarrays(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def restore_ndarrays(obj: Any) -> Any:
    """Inverse of :func:`jsonify_ndarrays` (bit-exact: the arrays ride as
    raw little-endian bytes)."""
    if isinstance(obj, dict):
        if set(obj.keys()) == {_ND_TAG}:
            return decode_array(obj[_ND_TAG])
        return {k: restore_ndarrays(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [restore_ndarrays(v) for v in obj]
    return obj


def _pack_frame(obj: Dict[str, Any], compress: Optional[bool] = None
                ) -> bytes:
    payload = json.dumps(obj, default=str).encode("utf-8")
    flags = 0
    if compress is None:
        compress = len(payload) > COMPRESS_OVER_BYTES
    if compress:
        packed = zlib.compress(payload, 6)
        if len(packed) < len(payload):
            payload = packed
            flags |= FLAG_ZLIB
    return _FRAME_HEAD.pack(len(payload), zlib.crc32(payload), flags) + payload


class RecordingWriter:
    """Append-only frame writer.

    ``path`` is a directory (chunked recorder output; created if absent)
    unless ``single_file`` — then it is one file holding every frame (the
    minted form).  Chunks rotate once the active one exceeds
    ``chunk_bytes``; rotation fsyncs the finished chunk so a later crash
    cannot lose it."""

    def __init__(self, path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 single_file: bool = False):
        self.path = str(path)
        self.chunk_bytes = max(4096, int(chunk_bytes))
        self.single_file = bool(single_file)
        self.bytes_written = 0
        self.frames_written = 0
        self._chunk_index = -1
        self._fh = None
        if not self.single_file:
            os.makedirs(self.path, exist_ok=True)
            existing = chunk_files(self.path)
            if existing:
                raise FileExistsError(
                    f"recording directory {self.path!r} already holds "
                    f"{len(existing)} chunk(s) — refusing to interleave "
                    "two recordings"
                )
        self._open_next()

    def _chunk_path(self, index: int) -> str:
        return os.path.join(
            self.path, f"{CHUNK_GLOB_PREFIX}{index:05d}{CHUNK_SUFFIX}"
        )

    def _open_next(self) -> None:
        if self._fh is not None:
            self._sync_close()
        self._chunk_index += 1
        target = (
            self.path if self.single_file
            else self._chunk_path(self._chunk_index)
        )
        self._fh = open(target, "wb")
        self._fh.write(MAGIC)
        self.bytes_written += len(MAGIC)

    def _sync_close(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None

    def append(self, obj: Dict[str, Any],
               compress: Optional[bool] = None) -> None:
        if self._fh is None:
            raise ValueError("writer is closed")
        frame = _pack_frame(obj, compress=compress)
        self._fh.write(frame)
        self.bytes_written += len(frame)
        self.frames_written += 1
        if (not self.single_file
                and self._fh.tell() >= self.chunk_bytes):
            self._open_next()

    def close(self) -> None:
        if self._fh is not None:
            self._sync_close()


@dataclasses.dataclass
class ReadStatus:
    """How a read ended.  ``clean`` means every byte parsed; a truncated
    or corrupt recording still yields its good prefix of frames."""

    frames: int = 0
    chunks: int = 0
    truncated: bool = False    # EOF inside a frame (writer crashed)
    corrupt: bool = False      # CRC mismatch (stopped at last good frame)
    detail: str = ""

    @property
    def clean(self) -> bool:
        return not (self.truncated or self.corrupt)

    def to_dict(self) -> dict:
        return {
            "frames": self.frames, "chunks": self.chunks,
            "truncated": self.truncated, "corrupt": self.corrupt,
            "clean": self.clean,
            **({"detail": self.detail} if self.detail else {}),
        }


def chunk_files(path: str) -> List[str]:
    """The recording directory's chunk files, in append order."""
    try:
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith(CHUNK_GLOB_PREFIX) and n.endswith(CHUNK_SUFFIX)
        )
    except NotADirectoryError:
        return []
    return [os.path.join(path, n) for n in names]


def _check_magic(head: bytes, source: str) -> None:
    if len(head) < len(MAGIC) or head[:len(_MAGIC_PREFIX)] != _MAGIC_PREFIX:
        raise ReplayFormatError(f"{source}: not a flight recording")
    version = head[len(_MAGIC_PREFIX)]
    if version != SCHEMA_VERSION:
        raise ReplayFormatError(
            f"{source}: recording schema version {version}, this build "
            f"reads version {SCHEMA_VERSION} only"
        )


def _iter_file_frames(fp: str, status: ReadStatus
                      ) -> Iterator[Dict[str, Any]]:
    with open(fp, "rb") as f:
        head = f.read(len(MAGIC))
        _check_magic(head, fp)
        while True:
            hdr = f.read(_FRAME_HEAD.size)
            if not hdr:
                return  # clean end of chunk
            if len(hdr) < _FRAME_HEAD.size:
                status.truncated = True
                status.detail = f"{fp}: EOF inside frame header"
                return
            length, crc, flags = _FRAME_HEAD.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length:
                status.truncated = True
                status.detail = f"{fp}: EOF inside frame payload"
                return
            if zlib.crc32(payload) != crc:
                status.corrupt = True
                status.detail = f"{fp}: CRC mismatch at frame {status.frames}"
                return
            if flags & FLAG_ZLIB:
                payload = zlib.decompress(payload)
            try:
                obj = json.loads(payload.decode("utf-8"))
            except ValueError:
                status.corrupt = True
                status.detail = (
                    f"{fp}: undecodable payload at frame {status.frames}"
                )
                return
            status.frames += 1
            yield obj


def read_frames(path: str) -> Tuple[List[Dict[str, Any]], ReadStatus]:
    """Every frame of a recording (directory of chunks, or one file),
    stopping cleanly at a truncated tail or corrupt frame — a broken
    frame also discards the chunks after it (tick continuity is gone).
    Raises :class:`ReplayFormatError` only for a foreign or
    version-mismatched magic, and ``FileNotFoundError`` for no recording
    at all."""
    status = ReadStatus()
    if os.path.isdir(path):
        files = chunk_files(path)
        if not files:
            raise FileNotFoundError(f"no recording chunks under {path!r}")
    elif os.path.exists(path):
        files = [path]
    else:
        raise FileNotFoundError(path)
    frames: List[Dict[str, Any]] = []
    for fp in files:
        status.chunks += 1
        for obj in _iter_file_frames(fp, status):
            frames.append(obj)
        if not status.clean:
            break
    return frames, status
