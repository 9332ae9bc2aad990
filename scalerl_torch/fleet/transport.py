"""Connection primitives for the actor fleet: sockets and process pipes.

Port of ``scalerl_tpu/fleet/transport.py``.  Parity target:
``PickledConnection`` + the socket/pipe helpers of
``scalerl/hpc/connection.py:12-204``.  Same capability surface — blocking
framed send/recv over TCP, listen/accept/connect with retry, and N-process
pipe fan-out — but every payload goes through the flat binary codec
(``framing.py``) instead of pickle, so the same bytes flow over DCN sockets
and local pipes.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
from typing import Any, Callable, List, Optional, Tuple

from scalerl_torch.fleet.framing import (
    _LEN,
    ProtocolError,
    pack_message,
    recv_frame,
    send_frame,
    unpack_message,
)
from scalerl_torch.runtime import chaos


class Connection:
    """Uniform duplex message connection (codec-framed)."""

    def send(self, msg: Any, compress: bool = False) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def poll(self, timeout: float = 0.0) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def fileno(self) -> int:
        raise NotImplementedError


class SocketConnection(Connection):
    def __init__(self, sock: socket.socket, chaos_site: str = "sock") -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.chaos_site = chaos_site

    def send(self, msg: Any, compress: bool = False) -> None:
        data = pack_message(msg, compress=compress)
        inj = chaos.active()
        if inj is None:
            send_frame(self.sock, data)
            return
        frames, kill = inj.frame_faults(data, site=self.chaos_site)
        for f in frames:
            send_frame(self.sock, f)
        if kill is not None:
            # mid-frame peer death: the length prefix promises the full
            # frame, the bytes stop half-way, then the link dies — the peer
            # sees ConnectionError("peer closed mid-frame")
            try:
                self.sock.sendall(_LEN.pack(len(data)) + kill)
            finally:
                self.close()
            raise ProtocolError("chaos: peer killed mid-frame")

    def recv(self, timeout: Optional[float] = None) -> Any:
        # timeout applies only to frame *arrival*: once the length prefix
        # starts, reads block to completion — a mid-frame timeout would
        # discard consumed bytes and desynchronize the stream
        if timeout is not None and not self.poll(timeout):
            raise TimeoutError("socket recv timed out")
        return unpack_message(recv_frame(self.sock))

    def poll(self, timeout: float = 0.0) -> bool:
        import select

        r, _, _ = select.select([self.sock], [], [], timeout)
        return bool(r)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def fileno(self) -> int:
        return self.sock.fileno()


class PipeConnection(Connection):
    """mp.Pipe end speaking the same codec (bytes over the pipe)."""

    def __init__(self, conn, chaos_site: str = "pipe") -> None:
        self.conn = conn
        self.chaos_site = chaos_site

    def send(self, msg: Any, compress: bool = False) -> None:
        data = pack_message(msg, compress=compress)
        inj = chaos.active()
        if inj is None:
            self.conn.send_bytes(data)
            return
        frames, kill = inj.frame_faults(data, site=self.chaos_site)
        for f in frames:
            self.conn.send_bytes(f)
        if kill is not None:
            # pipes frame at message level, so "mid-frame" is a truncated
            # message followed by a dead fd
            try:
                self.conn.send_bytes(kill)
            finally:
                self.close()
            raise ProtocolError("chaos: peer killed mid-frame")

    def recv(self, timeout: Optional[float] = None) -> Any:
        if timeout is not None and not self.conn.poll(timeout):
            raise TimeoutError("pipe recv timed out")
        return unpack_message(self.conn.recv_bytes())

    def poll(self, timeout: float = 0.0) -> bool:
        return self.conn.poll(timeout)

    def close(self) -> None:
        self.conn.close()

    def fileno(self) -> int:
        return self.conn.fileno()


def send_recv(conn: Connection, msg: Any, timeout: Optional[float] = None) -> Any:
    """Send ``msg`` and wait for the reply; ``timeout`` bounds the wait
    for the reply's arrival (``TimeoutError``)."""
    conn.send(msg)
    return conn.recv(timeout=timeout)


def wait_readable(
    conns: List[Connection], timeout: float = 0.05
) -> Tuple[List[Connection], List[Connection]]:
    """One ``select`` over all connections: (readable, dead).

    O(1) sweep regardless of fleet size — per-connection ``poll`` loops pay
    ``timeout`` per *idle* connection.  Closed/invalid fds come back in
    ``dead`` for the caller to drop.
    """
    import select

    by_fd = {}
    dead: List[Connection] = []
    for c in conns:
        try:
            by_fd[c.fileno()] = c
        except (OSError, ValueError):
            dead.append(c)
    if not by_fd:
        if not dead:
            time.sleep(timeout)
        return [], dead
    try:
        r, _, _ = select.select(list(by_fd), [], [], timeout)
    except (OSError, ValueError):
        # some fd went bad between fileno() and select: probe individually
        ready = []
        for fd, c in list(by_fd.items()):
            try:
                rr, _, _ = select.select([fd], [], [], 0)
            except (OSError, ValueError):
                dead.append(c)
                continue
            ready.extend(rr)
        r = ready
    return [by_fd[fd] for fd in r], dead


# ---------------------------------------------------------------------------
# bring-up helpers


def listen_socket(port: int, host: str = "", backlog: int = 128) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    return sock


def accept_connection(server_sock: socket.socket, timeout: Optional[float] = None) -> SocketConnection:
    server_sock.settimeout(timeout)
    try:
        sock, _addr = server_sock.accept()
        return SocketConnection(sock)
    finally:
        server_sock.settimeout(None)


def connect_socket(
    host: str,
    port: int,
    retries: int = 30,
    delay: float = 0.2,
    backoff_cap: Optional[float] = None,
) -> SocketConnection:
    """Connect with retry — fleet bring-up order is not deterministic.

    ``backoff_cap``: when set, the retry delay grows exponentially from
    ``delay`` up to the cap (``supervisor.exp_backoff``) instead of staying
    fixed — the reconnect-after-server-loss schedule, where hammering a
    recovering learner at a fixed high rate helps nobody.
    """
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.runtime.supervisor import exp_backoff

    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            sock = socket.create_connection((host, port), timeout=10.0)
            sock.settimeout(None)
            if attempt:
                # bring-up visibility: how many dials a connection cost is
                # the earliest signal of a flapping learner/NAT
                telemetry.get_registry().counter("transport.connect_retries").inc(
                    attempt
                )
                telemetry.record_event(
                    "connect_retried", host=host, port=port, attempts=attempt + 1
                )
            return SocketConnection(sock)
        except OSError as e:  # server not up yet
            last = e
            time.sleep(
                exp_backoff(attempt, delay, backoff_cap)
                if backoff_cap is not None
                else delay
            )
    telemetry.record_event(
        "connect_failed", host=host, port=port, attempts=retries
    )
    raise ConnectionError(f"could not connect to {host}:{port}") from last


def open_worker_pipes(
    n: int,
    target: Callable[..., None],
    args_fn: Callable[[int], Tuple],
    ctx: Optional[mp.context.BaseContext] = None,
) -> Tuple[List[PipeConnection], List[mp.Process]]:
    """Spawn ``n`` worker processes, each holding one end of a duplex pipe.

    Parity: ``open_multiprocessing_connections``
    (``scalerl/hpc/connection.py:179-204``).  ``args_fn(i)`` builds the
    worker's extra args; the worker ``target`` receives
    ``(pipe_connection, *args_fn(i))``.

    When no ``ctx`` is given and CUDA is initialized in this process,
    workers start via spawn (``target``/args must then be picklable) — see
    ``utils.platform.safe_mp_context``.
    """
    if ctx is None:
        from scalerl_torch.utils.platform import safe_mp_context

        ctx = mp.get_context(safe_mp_context(None))
    conns: List[PipeConnection] = []
    procs: List[mp.Process] = []
    for i in range(n):
        parent, child = ctx.Pipe(duplex=True)
        proc = ctx.Process(
            target=_pipe_worker_main,
            args=(target, child, args_fn(i)),
            daemon=True,
        )
        proc.start()
        child.close()
        conns.append(PipeConnection(parent))
        procs.append(proc)
    return conns, procs


def _pipe_worker_main(target, child_conn, extra_args) -> None:
    target(PipeConnection(child_conn), *extra_args)
