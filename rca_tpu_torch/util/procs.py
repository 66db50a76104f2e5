"""The one place the port spawns long-lived child processes (the port's
copy of ``rca_tpu.util.procs``).

The serve federation (:mod:`rca_tpu_torch.serve.federation`) supervises N
worker PROCESSES, each of which owns its own CUDA context.  Long-lived
children are built here for the same reasons threads live in
:mod:`rca_tpu_torch.util.threads` and sockets in
:mod:`rca_tpu_torch.util.net`:

- **named, attributable processes**: ``spawn_worker("fed-worker0",
  argv)`` stamps an owner name into the handle, so a leaked child, a
  nonzero exit, or a SIGKILL in a chaos run names its owner instead of
  a bare pid;
- **captured output, never a deadlock**: stdout/stderr are drained by
  named reader threads into bounded buffers, so a chatty child can never
  fill a pipe and wedge both processes, and a crashed worker's last
  stderr lines are there for the failure report;
- **one termination protocol**: ``terminate()`` is the polite
  SIGTERM→wait→SIGKILL ladder, ``kill()`` is the chaos seam's
  immediate SIGKILL (the ``process_kill`` fault class), both
  idempotent, both safe on an already-dead child;
- **fork+exec, never a bare fork**: children start through
  ``subprocess.Popen`` (a fresh interpreter), never through
  ``multiprocessing``'s fork: a coordinator that holds a CUDA context
  must not hand a copy of it to a child, which could not use it.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from rca_tpu_torch.util.threads import make_lock, spawn

#: bytes of child stdout/stderr kept per stream (oldest dropped) — the
#: buffers exist for failure reports, not log shipping
CAPTURE_CAP = 256 * 1024

#: the kernel's task flag for a process inside ``do_exit`` (Linux)
_PF_EXITING = 0x4


class WorkerProc:
    """One supervised child process: named, output-captured, with the
    SIGTERM→SIGKILL termination ladder.  Built via :func:`spawn_worker`
    only (the procs seam)."""

    def __init__(self, name: str, proc: "subprocess.Popen",
                 argv: List[str]):
        self.name = name
        self.proc = proc
        self.argv = list(argv)
        self._lock = make_lock("WorkerProc._lock")
        self._out: List[bytes] = []
        self._err: List[bytes] = []
        self._out_bytes = 0
        self._err_bytes = 0
        self._readers = [
            spawn(self._drain, name=f"rca-proc-{name}-out", daemon=True,
                  args=(proc.stdout, self._out, "out")),
            spawn(self._drain, name=f"rca-proc-{name}-err", daemon=True,
                  args=(proc.stderr, self._err, "err")),
        ]

    @property
    def pid(self) -> int:
        return int(self.proc.pid)

    def _drain(self, stream, sink: List[bytes], which: str) -> None:
        """Reader-thread body: drain one pipe into its bounded buffer.
        Runs until EOF (child exit) — the child can never block on a
        full pipe."""
        while True:
            chunk = stream.readline()
            if not chunk:
                return
            with self._lock:
                sink.append(chunk)
                if which == "out":
                    self._out_bytes += len(chunk)
                    while self._out_bytes > CAPTURE_CAP and len(sink) > 1:
                        self._out_bytes -= len(sink.pop(0))
                else:
                    self._err_bytes += len(chunk)
                    while self._err_bytes > CAPTURE_CAP and len(sink) > 1:
                        self._err_bytes -= len(sink.pop(0))

    # -- state ---------------------------------------------------------------
    def alive(self) -> bool:
        return self.proc.poll() is None

    def exiting(self) -> bool:
        """True once the child has exited or is on its way out: reaped,
        a zombie, or flagged ``PF_EXITING`` in ``/proc/<pid>/stat``
        (Linux; elsewhere only the reap counts).  A SIGKILLed process
        that held a CUDA context keeps its sockets open while the kernel
        unmaps its device memory, which can take longer than a lease."""
        if not self.alive():
            return True
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as fh:
                stat = fh.read()
        except OSError:
            return False
        # after "(comm) ": field 0 is the state, field 6 the flags
        fields = stat[stat.rfind(b")") + 2:].split()
        return (fields[0] in (b"Z", b"X")
                or bool(int(fields[6]) & _PF_EXITING))

    @property
    def returncode(self) -> Optional[int]:
        return self.proc.poll()

    def output(self) -> Tuple[str, str]:
        """Captured (stdout, stderr) so far, newest-complete — the
        failure report's evidence."""
        with self._lock:
            out = b"".join(self._out)
            err = b"".join(self._err)
        return (out.decode("utf-8", "replace"),
                err.decode("utf-8", "replace"))

    # -- termination ladder --------------------------------------------------
    def terminate(self, grace_s: float = 5.0) -> Optional[int]:
        """Polite stop: SIGTERM, wait ``grace_s``, then SIGKILL.
        Idempotent; returns the exit code (None only if the child
        somehow survives SIGKILL's wait)."""
        if self.alive():
            self.proc.terminate()
            try:
                return self.proc.wait(grace_s)
            except subprocess.TimeoutExpired:
                pass
        return self.kill()

    def kill(self, wait_s: float = 5.0) -> Optional[int]:
        """Immediate SIGKILL — the ``process_kill`` chaos seam.  A dead
        worker mid-request is exactly the failure the federation's
        drain-and-reroute must absorb."""
        if self.alive():
            self.proc.kill()
        try:
            return self.proc.wait(wait_s)
        except subprocess.TimeoutExpired:  # pragma: no cover - kernel lag
            return None

    def communicate(self, timeout: Optional[float] = None
                    ) -> Tuple[int, str, str]:
        """Wait for the child to exit and its pipes to drain; returns
        ``(exit code, stdout, stderr)`` (the bounded buffers' contents).
        Raises ``subprocess.TimeoutExpired`` when the child outlives
        ``timeout``."""
        code = self.proc.wait(timeout)
        for reader in self._readers:
            reader.join()
        out, err = self.output()
        return code, out, err

    def join(self, timeout: Optional[float] = None) -> Optional[int]:
        """Wait for natural exit; returns the code, None on timeout."""
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None


def spawn_worker(
    name: str,
    argv: List[str],
    env: Optional[Dict[str, str]] = None,
) -> WorkerProc:
    """Spawn one named, output-captured child process (the seam).

    ``env`` REPLACES the inherited environment when given (callers merge
    ``os.environ`` themselves if they want inheritance — an implicit
    merge is how env-dependent test pollution is born)."""
    proc = subprocess.Popen(
        list(argv),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=env,
    )
    return WorkerProc(name, proc, argv)


def python_argv(module: str, *args: str) -> List[str]:
    """``argv`` for a ``python -m <module>`` child under THIS
    interpreter — the federation worker's spawn shape."""
    return [sys.executable, "-m", module, *args]
