"""Rule ``thread-discipline``: threads, locks, sockets and long-lived
child processes are built in ONE place each.

Raw ``threading.Thread(...)`` / ``threading.Lock()`` (and the rest of the
lock family) construction anywhere in ``rca_tpu_torch/`` outside
``rca_tpu_torch/util/threads.py`` (and the rsan shim, which wraps the raw
primitives by definition) is a finding.  The seam is what makes a stack
dump and gravelock's analyses trustworthy: every thread is named with an
explicit daemon flag, and every lock carries its ``"Class.attr"``
identity.

The same discipline covers SOCKETS: raw ``socket.socket(...)`` (or
``socket.create_server`` / ``create_connection``) construction outside
``rca_tpu_torch/util/net.py`` is a finding — listeners are named, reuse
and backlog decisions are made once, and an address-in-use failure is
attributable to its owner.  Library-internal sockets (``http.client``,
the HTTP server's accepted connections) are stdlib code, out of scope by
construction.

And long-lived CHILD PROCESSES: raw ``subprocess.Popen(...)``,
``os.fork()``, and any ``multiprocessing`` construction outside
``rca_tpu_torch/util/procs.py`` is a finding — a child spawned outside the
seam has no owner name, no output capture, and no termination ladder.
One-shot ``subprocess.run``/``check_output`` calls stay legal: they own no
life cycle to supervise.

Subclassing ``threading.Thread`` stays legal (the subclass calls
``super().__init__(name=..., daemon=...)``), and so does
``threading.Event`` (a signal, not a mutual-exclusion region).
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

SEAM = "rca_tpu_torch/util/threads.py"
NET_SEAM = "rca_tpu_torch/util/net.py"
PROC_SEAM = "rca_tpu_torch/util/procs.py"
#: the rsan shim wraps the raw primitives by definition
EXEMPT = (SEAM, "rca_tpu_torch/analysis/concurrency/rsan.py")
NET_EXEMPT = (NET_SEAM,)
PROC_EXEMPT = (PROC_SEAM,)

BANNED = {
    "Thread", "Lock", "RLock", "Condition", "Semaphore",
    "BoundedSemaphore",
}

#: socket-constructing callables (module attribute form: socket.<name>)
NET_BANNED = {"socket", "create_server", "create_connection"}

#: long-lived child-process constructors: subprocess.Popen and os.fork
#: (subprocess.run/call/check_output are one-shots and stay legal);
#: multiprocessing is banned wholesale — ANY attribute call on the
#: module (Process, Pool, fork helpers) builds unsupervised children
PROC_BANNED = {("subprocess", "Popen"), ("os", "fork")}

MESSAGE = (
    "raw `threading.{name}(...)` construction outside {seam} — use "
    "make_lock/make_rlock/make_condition/make_thread/spawn so the "
    "primitive is named, rsan-shimmable, and visible to gravelock's "
    "thread-root discovery"
)

NET_MESSAGE = (
    "raw `socket.{name}(...)` construction outside {seam} — use "
    "make_server_socket so the listener is named, reuse/backlog policy "
    "is decided once, and bind failures are attributable"
)

PROC_MESSAGE = (
    "raw `{name}(...)` child-process construction outside {seam} — use "
    "spawn_worker so the child is named, its output is drained into "
    "bounded buffers, and it dies through the SIGTERM→SIGKILL ladder "
    "(one-shot subprocess.run stays legal)"
)


@register
class ThreadDisciplineRule(Rule):
    name = "thread-discipline"
    summary = ("threading.Thread/Lock/... constructed only via "
               "rca_tpu_torch/util/threads.py (named); socket.socket only "
               "via rca_tpu_torch/util/net.py; subprocess.Popen/os.fork/"
               "multiprocessing only via rca_tpu_torch/util/procs.py")
    why = ("an anonymous raw thread, lock, listening socket, or child "
           "process is invisible to stack dumps, lock analyses and fd/pid "
           "attribution — they are only as sound as the constructor "
           "seams are complete")

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith("rca_tpu_torch/")
                and relpath not in EXEMPT)

    def scan(self, ctx: FileContext) -> List[Finding]:
        # names imported straight from threading/socket/subprocess/os
        # count as raw too
        from_threading = set()
        from_socket = set()
        from_proc = set()
        mp_aliases = {"multiprocessing"}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "threading":
                    for alias in node.names:
                        if alias.name in BANNED:
                            from_threading.add(alias.asname or alias.name)
                elif node.module == "socket":
                    for alias in node.names:
                        if alias.name in NET_BANNED:
                            from_socket.add(alias.asname or alias.name)
                elif node.module in ("subprocess", "os"):
                    for alias in node.names:
                        if (node.module, alias.name) in PROC_BANNED:
                            from_proc.add(alias.asname or alias.name)
                elif node.module == "multiprocessing":
                    for alias in node.names:
                        from_proc.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "multiprocessing":
                        mp_aliases.add(alias.asname or alias.name)

        net_applies = ctx.relpath not in NET_EXEMPT
        proc_applies = ctx.relpath not in PROC_EXEMPT
        hits: List[Finding] = []

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.Call):
                f = node.func
                bad = None
                bad_net = None
                bad_proc = None
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)):
                    if f.value.id == "threading" and f.attr in BANNED:
                        bad = f.attr
                    elif f.value.id == "socket" and f.attr in NET_BANNED:
                        bad_net = f.attr
                    elif (f.value.id, f.attr) in PROC_BANNED:
                        bad_proc = f"{f.value.id}.{f.attr}"
                    elif f.value.id in mp_aliases:
                        bad_proc = f"{f.value.id}.{f.attr}"
                elif isinstance(f, ast.Name):
                    if f.id in from_threading:
                        bad = f.id
                    elif f.id in from_socket:
                        bad_net = f.id
                    elif f.id in from_proc:
                        bad_proc = f.id
                if bad is not None:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        MESSAGE.format(name=bad, seam=SEAM), func=func,
                    ))
                elif bad_net is not None and net_applies:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        NET_MESSAGE.format(name=bad_net, seam=NET_SEAM),
                        func=func,
                    ))
                elif bad_proc is not None and proc_applies:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        PROC_MESSAGE.format(name=bad_proc, seam=PROC_SEAM),
                        func=func,
                    ))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
        return hits
