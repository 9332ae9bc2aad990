"""The process plane's shared machinery: actor processes over the shm ring.

``trainer/parallel_dqn.py`` and ``trainer/process_actor_learner.py`` both
spawn actor processes that write slots into a ``ShmRolloutRing`` and pull
versioned numpy weights over a pipe.  What they share lives here:

- :func:`run_actor`, the actor side's error funnel.  An actor that fails
  while the ring is open sends ``{"kind": "error", "traceback"}`` and exits
  1; a closed ring (the learner's stop flag) is the only clean way out.  A
  reply timeout on the weight pull (``TimeoutError``) is a failure too,
  never a quiet exit.
- :class:`ProcessPlaneMixin`, the learner side: spawning (``spawn``, since
  the learner may hold a CUDA context), the weight service thread (the
  ``params``/``stats``/``report``/``error`` arms of the pipe protocol),
  death detection with a grace period for a child still tearing down, and
  the teardown ladder.  A dead actor is respawned only where the trainer
  grants it (:meth:`ProcessPlaneMixin._may_respawn`); otherwise its failure
  is recorded and :meth:`ProcessPlaneMixin.raise_actor_error` raises it in
  the learner.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List

from scalerl_torch.fleet.transport import PipeConnection, wait_readable
from scalerl_torch.runtime.param_server import PULL_TIMEOUT_S
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# seconds a parked actor (pipe gone, process alive) may take to exit
DYING_GRACE_S = 30.0


def _send_error(conn: PipeConnection, actor_id: int) -> None:
    try:
        conn.send({"kind": "error", "actor_id": actor_id, "traceback": traceback.format_exc()})
    except Exception:  # noqa: BLE001 - the pipe may be the casualty
        pass


def run_actor(conn: PipeConnection, actor_id: int, ring, body: Callable[[], None]) -> None:
    """Run an actor process's ``body`` and funnel its failure.

    ``body`` returns once it sees ``ring.closed``.  A pipe or OS error
    (``TimeoutError`` included) is benign only once the ring is closed: the
    learner closes the ring before the pipes.  Any other failure sends its
    traceback to the learner and exits 1, so it is never taken for a clean
    departure.  The ring's mapping is dropped and the pipe closed either
    way."""
    failed = False
    try:
        body()
    except KeyboardInterrupt:
        pass
    except (EOFError, OSError, ConnectionError):
        if not ring.closed:
            failed = True
            _send_error(conn, actor_id)
    except Exception:  # noqa: BLE001 - funneled to the learner
        failed = True
        _send_error(conn, actor_id)
    finally:
        ring.detach()
        try:
            conn.close()
        except OSError:
            pass
    if failed:
        sys.exit(1)


class ProcessPlaneMixin:
    """Learner side of the process plane.

    The trainer calls :meth:`_init_process_plane` once its ``ring``,
    ``param_server``, ``stop_event`` and ``returns`` exist, implements
    :meth:`_actor_configs`, and checks :meth:`raise_actor_error` in its
    loop.  Each config must carry ``pull_timeout_s``, which
    :attr:`pull_timeout_s` sets."""

    # seconds an actor waits for the weight service's reply
    pull_timeout_s = PULL_TIMEOUT_S

    def _init_process_plane(self, actor_main: Callable) -> None:
        self._actor_main = actor_main
        self._ctx = mp.get_context("spawn")
        self.procs: List[mp.process.BaseProcess] = []
        self.conns: List[PipeConnection] = []
        self._actor_of: Dict[PipeConnection, int] = {}
        self._cfgs: List[Any] = []
        self._dying: Dict[int, float] = {}  # actor_id -> recheck deadline
        self._actor_error: List[str] = []
        self.child_reports: Dict[int, Dict[str, Any]] = {}
        # each actor's latest mean seconds a slot phase, where it reports them
        self.actor_timings: Dict[int, Dict[str, float]] = {}
        self._weight_thread = threading.Thread(target=self._weight_service, daemon=True)
        self._stopped = False

    def _actor_configs(self) -> List[Any]:
        raise NotImplementedError

    def _may_respawn(self, actor_id: int, exc: BaseException) -> bool:
        """Whether a failed actor is respawned; the default fails fast."""
        return False

    def raise_actor_error(self) -> None:
        if self._actor_error:
            raise RuntimeError("actor process failed:\n" + "\n".join(self._actor_error))

    # -- spawning -------------------------------------------------------
    def start_actors(self) -> None:
        # spawn, not fork: the learner may hold a CUDA context, which a
        # forked child must not inherit.  Everything crossing the boundary
        # (the config, PipeConnection, ShmRolloutRing) is picklable.
        self._cfgs = self._actor_configs()
        for i in range(len(self._cfgs)):
            self._spawn_actor(i)
        self._weight_thread.start()

    def _retire_pipe(self, i: int) -> None:
        """Stop serving actor ``i``'s pipe: its end was seen, or it is
        being replaced."""
        for c, a in list(self._actor_of.items()):
            if a == i:
                self._actor_of.pop(c, None)
                if c in self.conns:
                    self.conns.remove(c)
                try:
                    c.close()
                except OSError:
                    pass

    def _spawn_actor(self, i: int) -> None:
        self._retire_pipe(i)
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=self._actor_main,
                                 args=(PipeConnection(child), self._cfgs[i], self.ring),
                                 daemon=True)
        proc.start()
        child.close()
        if i < len(self.procs):
            self.procs[i] = proc
        else:
            self.procs.append(proc)
        conn = PipeConnection(parent)
        self.conns.append(conn)
        self._actor_of[conn] = i

    # -- failures -------------------------------------------------------
    def _on_actor_failure(self, actor_id: int, detail: str, exc: BaseException) -> None:
        if self._may_respawn(actor_id, exc):
            logger.warning("actor %d failed; respawning:\n%s", actor_id, detail)
            # no blocking join: it would stall the service for every other
            # actor; _spawn_actor retires the pipe
            self._spawn_actor(actor_id)
        else:
            self._retire_pipe(actor_id)  # its coming EOF is this failure
            self._actor_error.append(f"actor {actor_id}: {detail}")

    def _drop_conn(self, conn: PipeConnection, reason: str) -> None:
        """A connection died: its actor failed, unless we are shutting
        down."""
        if conn in self.conns:
            self.conns.remove(conn)
        actor_id = self._actor_of.pop(conn, None)
        if actor_id is None or self.stop_event.is_set():
            return
        proc = self.procs[actor_id]
        if proc.is_alive():
            # the pipe EOF'd while the process is still tearing down (the
            # actor closes its pipe before it exits): park it for the
            # service loop to recheck
            self._dying[actor_id] = time.monotonic() + DYING_GRACE_S
            return
        self._handle_actor_death(actor_id, reason, proc.exitcode)

    def _handle_actor_death(self, actor_id: int, reason: str, exitcode) -> None:
        if self.stop_event.is_set() or (exitcode == 0 and self.ring.closed):
            return  # a clean exit: the actor saw the ring closed
        detail = f"died ({reason}, exit {exitcode})"
        self._on_actor_failure(actor_id, detail, RuntimeError(detail))

    def _check_dying(self) -> None:
        """Recheck parked actors (pipe gone, process was still alive)."""
        for actor_id, deadline in list(self._dying.items()):
            proc = self.procs[actor_id]
            if not proc.is_alive():
                del self._dying[actor_id]
                self._handle_actor_death(actor_id, "pipe dead", proc.exitcode)
            elif time.monotonic() > deadline:
                del self._dying[actor_id]
                self._actor_error.append(
                    f"actor {actor_id}: pipe closed but process still alive after "
                    f"{DYING_GRACE_S:.0f}s (hung teardown)")

    # -- weight / stats / report / error service ------------------------
    def _answer_pull(self, conn: PipeConnection, have: int) -> None:
        weights, version = self.param_server.pull(have)
        try:
            conn.send(None if weights is None else {"version": version, "weights": weights})
        except (BrokenPipeError, OSError):
            pass  # the dead pipe shows up in the next sweep

    def _weight_service(self) -> None:
        while not self.stop_event.is_set():
            self._check_dying()
            if not self.conns:
                self.stop_event.wait(0.05)
                continue
            ready, dead = wait_readable(self.conns, timeout=0.1)
            for conn in dead:
                self._drop_conn(conn, "pipe dead")
            for conn in ready:
                try:
                    msg = conn.recv()
                except (EOFError, OSError, ConnectionError, ValueError):
                    self._drop_conn(conn, "recv failed")
                    continue
                if msg is None:
                    continue
                kind = msg["kind"]
                if kind == "params":
                    self._answer_pull(conn, int(msg["have"]))
                elif kind == "stats":
                    self.returns.extend(float(r) for r in msg["returns"])
                    if "timings" in msg:
                        self.actor_timings[int(msg["actor_id"])] = msg["timings"]
                elif kind == "report":
                    self.child_reports[int(msg["actor_id"])] = msg
                elif kind == "error":
                    tb = msg["traceback"]
                    self._on_actor_failure(int(msg["actor_id"]), "failed:\n" + tb,
                                           RuntimeError(tb.strip().splitlines()[-1]))

    # -- teardown -------------------------------------------------------
    def stop(self) -> None:
        """Close the ring (the actors' stop flag), stop the weight service,
        close the pipes (EOF unblocks an actor waiting on a reply), join
        the actors with a timeout, terminate stragglers, unlink the ring.
        A second call does nothing."""
        if self._stopped:
            return
        self._stopped = True
        self.ring.close()
        self.stop_event.set()
        if self._weight_thread.is_alive():
            self._weight_thread.join(timeout=2.0)
        for c in self.conns:
            try:
                c.close()
            except OSError:
                pass
        self.conns.clear()
        for p in self.procs:
            p.join(timeout=5.0)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        self.ring.unlink()
