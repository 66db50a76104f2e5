"""The one place the port constructs sockets (the port's copy of
``rca_tpu.util.net``).

The gateway (:mod:`rca_tpu_torch.gateway`) is the port's network surface,
and its listening sockets are built here for the reasons threads and locks
are built in :mod:`rca_tpu_torch.util.threads`:

- **named, attributable resources**: ``make_server_socket("gateway", host,
  port)`` stamps the purpose into the construction site, so an
  address-in-use failure names its owner;
- **one construction path**: reuse flags, backlog and the bind/listen
  sequence are decided once, so every listener behaves the same under
  restart (``SO_REUSEADDR``) and port-0 ephemeral binding (``serve
  --listen 127.0.0.1:0`` reads the kernel-chosen port back from the
  returned socket).

The HTTP server's accepted connections and ``http.client``'s outbound
sockets are library code and stay outside this seam.
"""

from __future__ import annotations

import socket
import ssl
from typing import Optional, Tuple


def make_server_socket(
    name: str,
    host: str,
    port: int,
    backlog: int = 64,
) -> socket.socket:
    """A bound, LISTENING TCP socket named for its owner.

    ``port`` 0 binds an ephemeral port — read the kernel's choice back via
    :func:`bound_address`.  Raises ``OSError`` (address in use,
    permission) with the owner's name prefixed."""
    if not 0 <= int(port) <= 65535:
        raise ValueError(f"{name}: port {port} out of range [0, 65535]")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, int(port)))
        sock.listen(int(backlog))
    except OSError as exc:
        sock.close()
        raise OSError(f"{name}: cannot listen on {host}:{port}: {exc}") from exc
    return sock


def make_client_socket(
    name: str,
    host: str,
    port: int,
    timeout_s: Optional[float] = None,
) -> socket.socket:
    """A CONNECTED TCP socket named for its owner, the outbound twin of
    :func:`make_server_socket`.  ``timeout_s`` bounds the connect; the
    socket is returned in blocking mode (callers set their own read
    deadlines)."""
    try:
        sock = socket.create_connection((host, int(port)), timeout=timeout_s)
    except OSError as exc:
        raise OSError(
            f"{name}: cannot connect to {host}:{port}: {exc}"
        ) from exc
    sock.settimeout(None)
    return sock


# -- TLS -----------------------------------------------------------------------

def make_tls_server_context(
    name: str, certfile: str, keyfile: str,
    client_ca: Optional[str] = None,
) -> ssl.SSLContext:
    """A server-side TLS context (TLS 1.2 and up), its cert loading
    failures attributed to ``name``.

    ``client_ca`` turns on mutual TLS: the listener DEMANDS a client
    certificate at the handshake and verifies it against that CA, so a
    client without one is rejected before a byte of HTTP is read."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    try:
        ctx.load_cert_chain(certfile=certfile, keyfile=keyfile)
    except (OSError, ssl.SSLError) as exc:
        raise ValueError(
            f"{name}: cannot load TLS cert/key "
            f"({certfile!r}, {keyfile!r}): {exc}"
        ) from exc
    if client_ca:
        try:
            ctx.load_verify_locations(cafile=client_ca)
        except (OSError, ssl.SSLError) as exc:
            raise ValueError(
                f"{name}: cannot load client CA {client_ca!r}: {exc}"
            ) from exc
        ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx


def make_tls_client_context(
    name: str, ca_file: Optional[str] = None,
    cert_file: Optional[str] = None, key_file: Optional[str] = None,
) -> ssl.SSLContext:
    """The client-side twin: with ``ca_file`` the server's cert is VERIFIED
    against it (a self-signed deployment pins its own cert); without one,
    verification is off — encryption without authentication, which the
    caller has to ask for by leaving the file out.  ``cert_file`` /
    ``key_file`` present the client's certificate to an mTLS gateway
    (``key_file`` defaults to the cert file holding both)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_file:
        try:
            ctx.load_verify_locations(cafile=ca_file)
        except (OSError, ssl.SSLError) as exc:
            raise ValueError(
                f"{name}: cannot load CA file {ca_file!r}: {exc}"
            ) from exc
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if cert_file:
        try:
            ctx.load_cert_chain(certfile=cert_file, keyfile=key_file)
        except (OSError, ssl.SSLError) as exc:
            raise ValueError(
                f"{name}: cannot load client cert/key "
                f"({cert_file!r}, {key_file!r}): {exc}"
            ) from exc
    return ctx


def primary_host_ip(name: str = "external") -> str:
    """This host's primary outbound IPv4 address, what a worker on another
    host would connect to when a listener binds 0.0.0.0.  A connected UDP
    socket sends no packet: the kernel only picks the route's source
    address.  Loopback on a host with no route."""
    del name
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.connect(("10.255.255.255", 1))
        return str(sock.getsockname()[0])
    except OSError:
        return "127.0.0.1"
    finally:
        sock.close()


def bound_address(sock: socket.socket) -> Tuple[str, int]:
    """The (host, port) a server socket actually bound — the kernel's
    choice when the requested port was 0."""
    host, port = sock.getsockname()[:2]
    return str(host), int(port)


def parse_hostport(spec: str, default_port: int) -> Tuple[str, int]:
    """``HOST[:PORT]`` → ``(host, port)``; a bare ``:PORT`` listens on
    127.0.0.1.  Malformed specs raise ``ValueError``."""
    spec = (spec or "").strip()
    if not spec:
        raise ValueError("empty listen address (want HOST:PORT)")
    if ":" in spec:
        host, _, port_s = spec.rpartition(":")
        host = host or "127.0.0.1"
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"listen address {spec!r}: port {port_s!r} is not an integer"
            )
    else:
        host, port = spec, default_port
    if not 0 <= port <= 65535:
        raise ValueError(
            f"listen address {spec!r}: port {port} out of range [0, 65535]"
        )
    return host, port
