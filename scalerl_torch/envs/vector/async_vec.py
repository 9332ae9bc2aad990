"""Async subprocess vector env with a shared-memory observation plane.

Port of ``scalerl_tpu/envs/vector/async_vec.py``.  Parity target:
``AsyncPettingZooVecEnv`` (``scalerl/envs/vector/pz_async_vec_env.py:
36-897``): a subprocess per env, an async DEFAULT / WAITING_RESET /
WAITING_STEP / WAITING_CALL state machine, ``call``/``get_attr``/
``set_attr`` passthrough, autoreset, per-worker error funneling through an
``error_queue`` with targeted teardown, and shared-memory observations.

Works for any env speaking the PettingZoo *parallel* API
(``possible_agents``, ``reset``, dict-keyed ``step``), single-agent gym envs
included through ``SingleAgentAdapter``.  An env worker that dies (killed,
or gone without a reply) is an error the caller sees, naming the worker,
never a hang.
"""

from __future__ import annotations

import enum
import multiprocessing as mp
import queue
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from scalerl_torch.envs.vector.spec import ExperienceSpec, SharedObservationPlane
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)


class AsyncState(enum.Enum):
    DEFAULT = "default"
    WAITING_RESET = "reset"
    WAITING_STEP = "step"
    WAITING_CALL = "call"


class AlreadyPendingCallError(RuntimeError):
    pass


class NoAsyncCallError(RuntimeError):
    pass


class ClosedEnvError(RuntimeError):
    pass


def _probe_spaces(env_fn: Callable[[], Any]):
    """Create one env in-process to read agent names + obs/action spaces."""
    env = env_fn()
    try:
        agents = list(env.possible_agents)
        obs_spaces = {}
        action_spaces = {}
        for a in agents:
            space = env.observation_space(a)
            obs_spaces[a] = (tuple(space.shape), space.dtype)
            action_spaces[a] = env.action_space(a)
        return agents, obs_spaces, action_spaces
    finally:
        close = getattr(env, "close", None)
        if close:
            close()


class AsyncMultiAgentVecEnv:
    """N env subprocesses writing observations into a shared plane.

    ``context``: when unset and CUDA is initialized in this process, workers
    start by ``"spawn"`` (``utils/platform.py::safe_mp_context``): a forked
    child must not inherit a CUDA context.  Env factories must then be
    picklable (module-level callables, not lambdas).
    """

    def __init__(
        self,
        env_fns: Sequence[Callable[[], Any]],
        obs_spaces: Optional[Dict[str, Tuple[Tuple[int, ...], Any]]] = None,
        autoreset: bool = True,
        context: Optional[str] = None,
    ) -> None:
        from scalerl_torch.utils.platform import safe_mp_context

        self.num_envs = len(env_fns)
        ctx = mp.get_context(safe_mp_context(context))
        if obs_spaces is None:
            self.agents, obs_spaces, self.action_spaces = _probe_spaces(env_fns[0])
        else:
            self.agents = list(obs_spaces.keys())
            self.action_spaces = {}
        self.spec = ExperienceSpec(obs_spaces, self.num_envs)
        self.plane = SharedObservationPlane(self.spec, ctx=ctx)
        self.error_queue: mp.Queue = ctx.Queue()
        self._state = AsyncState.DEFAULT
        self._closed = False
        # replies still owed per worker after a _collect timeout; discarded
        # before the next fresh recv (replies are FIFO per worker)
        self._stale = [0] * self.num_envs
        self.parent_pipes = []
        self.processes = []
        for index, env_fn in enumerate(env_fns):
            parent, child = ctx.Pipe(duplex=True)
            proc = ctx.Process(
                target=_async_worker,
                args=(
                    index,
                    env_fn,
                    child,
                    parent,
                    self.plane,
                    self.agents,
                    autoreset,
                    self.error_queue,
                ),
                daemon=True,
            )
            proc.start()
            child.close()
            self.parent_pipes.append(parent)
            self.processes.append(proc)

    # -- async API -----------------------------------------------------
    def _assert_default(self, op: str) -> None:
        if self._closed:
            raise ClosedEnvError("vec env is closed")
        if self._state is not AsyncState.DEFAULT:
            raise AlreadyPendingCallError(
                f"cannot {op} while waiting for `{self._state.value}`"
            )

    def reset_async(self, seed: Optional[int] = None, options=None) -> None:
        self._assert_default("reset")
        for i in range(self.num_envs):
            env_seed = None if seed is None else seed + i
            self._send(i, ("reset", (env_seed, options)))
        self._state = AsyncState.WAITING_RESET

    def reset_wait(self, timeout: Optional[float] = 60.0):
        if self._state is not AsyncState.WAITING_RESET:
            raise NoAsyncCallError("no reset pending")
        results, successes = self._collect(timeout)
        self._state = AsyncState.DEFAULT
        self._raise_if_errors(successes)
        infos = [r for r in results]
        return self.plane.read_batch(), infos

    def reset(self, seed: Optional[int] = None, options=None, timeout=60.0):
        self.reset_async(seed=seed, options=options)
        return self.reset_wait(timeout)

    def step_async(self, actions: Dict[str, np.ndarray]) -> None:
        """``actions[agent]`` is a length-``num_envs`` batch; transposed to
        per-env dicts (reference ``pz_vec_env.py:53-68``)."""
        self._assert_default("step")
        for i in range(self.num_envs):
            per_env = {agent: np.asarray(acts)[i] for agent, acts in actions.items()}
            self._send(i, ("step", per_env))
        self._state = AsyncState.WAITING_STEP

    def step_wait(self, timeout: Optional[float] = 60.0):
        if self._state is not AsyncState.WAITING_STEP:
            raise NoAsyncCallError("no step pending")
        results, successes = self._collect(timeout)
        self._state = AsyncState.DEFAULT
        self._raise_if_errors(successes)
        rewards = {a: np.zeros(self.num_envs, np.float32) for a in self.agents}
        terms = {a: np.zeros(self.num_envs, np.bool_) for a in self.agents}
        truncs = {a: np.zeros(self.num_envs, np.bool_) for a in self.agents}
        infos: List[dict] = []
        for i, (rew, term, trunc, info) in enumerate(results):
            for a in self.agents:
                rewards[a][i] = rew.get(a, 0.0)
                terms[a][i] = term.get(a, True)
                truncs[a][i] = trunc.get(a, False)
            infos.append(info)
        return self.plane.read_batch(), rewards, terms, truncs, infos

    def step(self, actions: Dict[str, np.ndarray], timeout: Optional[float] = 60.0):
        self.step_async(actions)
        return self.step_wait(timeout)

    # -- attribute passthrough ----------------------------------------
    def call_async(self, name: str, *args, **kwargs) -> None:
        self._assert_default("call")
        for i in range(self.num_envs):
            self._send(i, ("call", (name, args, kwargs)))
        self._state = AsyncState.WAITING_CALL

    def call_wait(self, timeout: Optional[float] = 60.0) -> list:
        if self._state is not AsyncState.WAITING_CALL:
            raise NoAsyncCallError("no call pending")
        results, successes = self._collect(timeout)
        self._state = AsyncState.DEFAULT
        self._raise_if_errors(successes)
        return results

    def call(self, name: str, *args, **kwargs) -> list:
        self.call_async(name, *args, **kwargs)
        return self.call_wait()

    def get_attr(self, name: str) -> list:
        return self.call(name)

    def set_attr(self, name: str, values: Any) -> None:
        if not isinstance(values, (list, tuple)):
            values = [values] * self.num_envs
        if len(values) != self.num_envs:
            raise ValueError(
                f"set_attr needs {self.num_envs} values, got {len(values)}"
            )
        self._assert_default("set_attr")
        for i, value in enumerate(values):
            self._send(i, ("setattr", (name, value)))
        self._state = AsyncState.WAITING_CALL
        self.call_wait()

    # -- plumbing ------------------------------------------------------
    def _send(self, i: int, msg: Any) -> None:
        """A command to worker ``i``; a dead worker's closed pipe is an
        error naming it."""
        try:
            self.parent_pipes[i].send(msg)
        except (BrokenPipeError, OSError) as exc:
            proc = self.processes[i]
            proc.join(timeout=1.0)
            raise RuntimeError(
                f"env worker {i} is dead (exit code {proc.exitcode})"
            ) from exc

    def _collect(self, timeout: Optional[float]):
        """Gather one (result, success) pair per worker, with deadline.

        On timeout the state machine resets to DEFAULT before raising
        (gymnasium ``AsyncVectorEnv`` semantics) so the env is not wedged in
        a WAITING state forever.  Every worker that had not delivered its
        reply by the deadline is marked as owing one stale reply, which the
        next ``_collect`` discards before reading a fresh one — replies are
        FIFO per worker, so results can never desynchronize across steps.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        results, successes = [], []
        for i, pipe in enumerate(self.parent_pipes):
            try:
                # discard replies left over from a previous timed-out round
                while self._stale[i]:
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and (
                        remaining <= 0 or not pipe.poll(remaining)
                    ):
                        raise TimeoutError(
                            f"worker {i} did not respond in {timeout}s"
                        )
                    pipe.recv()
                    self._stale[i] -= 1
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and (
                    remaining <= 0 or not pipe.poll(remaining)
                ):
                    raise TimeoutError(f"worker {i} did not respond in {timeout}s")
            except TimeoutError:
                self._state = AsyncState.DEFAULT
                for j in range(i, self.num_envs):
                    self._stale[j] += 1
                raise
            try:
                result, ok = pipe.recv()
            except (EOFError, OSError) as exc:
                # the worker died between commands: its end of the pipe
                # closed with no reply
                self._state = AsyncState.DEFAULT
                proc = self.processes[i]
                proc.join(timeout=1.0)
                raise RuntimeError(
                    f"env worker {i} died (exit code {proc.exitcode}) without a reply"
                ) from exc
            results.append(result)
            successes.append(ok)
        return results, successes

    def _raise_if_errors(self, successes: Sequence[bool]) -> None:
        if all(successes):
            return
        num_errors = successes.count(False)
        last: Optional[BaseException] = None
        for _ in range(num_errors):
            try:
                index, exc_name, tb = self.error_queue.get(timeout=30.0)
            except queue.Empty:
                raise RuntimeError(
                    f"{num_errors} env worker(s) failed without a report"
                ) from None
            logger.error("env worker %d failed:\n%s", index, tb)
            # targeted teardown of the failed worker only
            self.parent_pipes[index].close()
            proc = self.processes[index]
            proc.join(timeout=1.0)
            if proc.is_alive():
                proc.terminate()
            last = RuntimeError(f"env worker {index} raised {exc_name}:\n{tb}")
        assert last is not None
        raise last

    def close(self, terminate: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        for pipe in self.parent_pipes:
            try:
                if not terminate:
                    pipe.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for proc in self.processes:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.terminate()
        for pipe in self.parent_pipes:
            try:
                pipe.close()
            except OSError:
                pass

    def __del__(self):
        try:
            self.close(terminate=True)
        except Exception:
            pass


def _fill_missing(obs: dict, agents: Sequence[str], spec: ExperienceSpec) -> dict:
    """Dead agents keep zero observations (reference 'fill dead agents',
    ``pz_async_vec_env.py:844-856``)."""
    out = dict(obs)
    for a in agents:
        if a not in out:
            slot = spec.slots[a]
            out[a] = np.zeros(slot.shape, slot.dtype)
    return out


def _async_worker(
    index: int,
    env_fn: Callable[[], Any],
    pipe,
    parent_pipe,
    plane: SharedObservationPlane,
    agents: Sequence[str],
    autoreset: bool,
    error_queue,
) -> None:
    parent_pipe.close()
    env = None
    try:
        env = env_fn()
        episode_return = {a: 0.0 for a in agents}
        episode_length = 0
        while True:
            command, payload = pipe.recv()
            if command == "reset":
                seed, options = payload
                obs, infos = env.reset(seed=seed, options=options)
                plane.write_env(index, _fill_missing(obs, agents, plane.spec))
                episode_return = {a: 0.0 for a in agents}
                episode_length = 0
                pipe.send((infos, True))
            elif command == "step":
                obs, rew, term, trunc, infos = env.step(payload)
                episode_length += 1
                for a, r in rew.items():
                    episode_return[a] = episode_return.get(a, 0.0) + float(r)
                all_done = all(
                    term.get(a, True) or trunc.get(a, False) for a in agents
                )
                if all_done and autoreset:
                    infos = dict(infos) if infos else {}
                    infos["final_observation"] = obs
                    infos["episode"] = {
                        "r": dict(episode_return),
                        "l": episode_length,
                    }
                    obs, reset_infos = env.reset()
                    episode_return = {a: 0.0 for a in agents}
                    episode_length = 0
                plane.write_env(index, _fill_missing(obs, agents, plane.spec))
                pipe.send(((rew, term, trunc, infos), True))
            elif command == "call":
                name, args, kwargs = payload
                if name in ("reset", "step", "close"):
                    raise ValueError(
                        f"use the dedicated API for `{name}`, not call()"
                    )
                attr = getattr(env, name)
                result = attr(*args, **kwargs) if callable(attr) else attr
                pipe.send((result, True))
            elif command == "setattr":
                name, value = payload
                setattr(env, name, value)
                pipe.send((None, True))
            elif command == "close":
                pipe.send((None, True))
                break
            else:
                raise RuntimeError(f"unknown command {command!r}")
    except (KeyboardInterrupt, EOFError):
        pass
    except Exception:
        error_queue.put((index, type(sys.exc_info()[1]).__name__,
                         traceback.format_exc()))
        try:
            pipe.send((None, False))
        except (BrokenPipeError, OSError):
            pass
    finally:
        if env is not None and hasattr(env, "close"):
            try:
                env.close()
            except Exception:
                pass
