"""The ranks of the gloo world behind tests/test_torch_serving_mesh.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group, runs every case of ``cases.pt`` (written by the test
module: the converted transformer-policy state, each case's requests and
the JAX server's Gumbel draws) through the port's ``InferenceServer``
beside a learner meshed at ``dp=2,mp=2``, and writes what it saw to
``rank<r>.pt``.
"""

import dataclasses
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

WAIT_S = 20.0
# collectives a push may not issue
_COLLECTIVES = ("all_gather", "all_reduce", "broadcast", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all", "scatter", "barrier")


def _agent(case, spec):
    from scalerl_torch.agents.impala import ImpalaAgent

    agent = ImpalaAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(spec)
    return agent


def _server(agent, case):
    from scalerl_torch.serving import InferenceServer, ServingConfig

    return InferenceServer(agent, ServingConfig(**case["serving"]))


class _Counted:
    """Counts the calls of the collectives in ``_COLLECTIVES`` while on."""

    def __enter__(self):
        self.calls, self._real = 0, {}
        for name in _COLLECTIVES:
            real = getattr(dist, name)
            self._real[name] = real

            def counted(*a, _real=real, **kw):
                self.calls += 1
                return _real(*a, **kw)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(dist, name, real)


def _layout(case):
    """What the server holds after construction, a push of whole host
    numpy weights and a push of the live state, and the collectives and
    DTensor gathers each push issued; a server beside a pure-dp learner."""
    from scalerl_torch.parallel import sharding

    agent = _agent(case, case["spec"])
    server = _server(agent, case)
    full = agent.get_weights()  # the acting copy: gathered before, no collective here

    def shapes():
        return {k: (tuple(v.shape), tuple(full[k].shape)) for k, v in server._params.items()}

    def live_equal():
        return all(torch.equal(server._params[k], sharding.to_local(v))
                   for k, v in agent.state.params.items())

    out = {"built": shapes(), "built_equal": live_equal()}
    pushes = {}
    for name, params in (("host", {k: v.numpy() for k, v in full.items()}),
                         ("live", agent.state.params)):
        before = sharding.GATHER_STATS["dtensor_gathers"]
        with _Counted() as counted:
            gen = server.push_params(params, learner_step=7)
        pushes[name] = dict(gen=gen, collectives=counted.calls, shapes=shapes(),
                            equal=live_equal(),
                            dtensor_gathers=sharding.GATHER_STATS["dtensor_gathers"] - before)
    out["pushes"] = pushes
    try:
        server.push_params({k: v[:1] for k, v in full.items()})
        out["bad_push"] = None
    except ValueError as e:
        out["bad_push"] = str(e)
    dp_only = _server(_agent(case, "dp=4"), case)
    out["dp_only"] = dict(specs=dp_only._param_specs, mesh=dp_only.mesh,
                          shapes={k: tuple(v.shape) for k, v in dp_only._params.items()})
    return out


def _recording(server, log, draws=None):
    """Record each pooled flush's whole-bucket logits and actions; with
    ``draws``, serve the JAX server's Gumbel draws in order."""
    real = server._serve

    def serve(params, *args):
        action, logits, core = real(params, *args)
        log.append((logits.clone(), action.clone()))
        return action, logits, core

    server._serve = serve
    if draws is not None:
        pending = list(draws)
        server._gumbel = lambda logits: torch.from_numpy(np.array(pending.pop(0)))


def _flushes(case):
    """The case's flushes driven tick by tick: each rank admits its own
    requests of the flush (none, on some), the group offers, then flushes
    on shards; the replies each rank received, the pooled outputs."""
    from scalerl_torch.serving import local_pair

    agent = _agent(case, case["spec"])
    server = _server(agent, case)
    group, coord = agent.mesh.coordinate("dp"), agent.mesh.coordinate("mp")
    pooled = []
    _recording(server, pooled, case["draws"][group])
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    replies, flushes = [], []
    try:
        for f, per_rank in enumerate(case["requests"][group]):
            mine = per_rank[coord]
            for req_id, payload in mine:
                server._admit(s_end, {"kind": "act", "req": req_id, **payload})
            # past the deadline, every request of the flush is due
            time.sleep(2 * case["serving"]["max_wait_s"])
            offered = server.batcher.ready()
            assert len(offered) == len(mine), (len(offered), len(mine))
            assert server._tick(offered) == "flushed"
            flushes.append(server.flushes)
            replies.extend(c_end.recv(timeout=WAIT_S) for _ in mine)
    finally:
        server.hub.close()
    return dict(replies=replies, pooled=pooled, flushes=flushes, puts=server.device_puts,
                gets=server.device_gets, buckets=sorted(server._warm_buckets),
                accounting=server.accounting())


def _loop(case):
    """The flush threads of every rank: only the first rank of each mp pair
    sends requests (its peer's queue stays empty and it flushes along);
    then the peer alone stops, which must end both loops."""
    from scalerl_torch.serving import RemotePolicyClient, local_pair

    agent = _agent(case, case["spec"])
    server = _server(agent, case)
    pooled = []
    _recording(server, pooled)
    coord = agent.mesh.coordinate("mp")
    c_end, s_end = local_pair()
    server.add_connection(s_end)
    server.start()
    actions = []
    if coord == 0:
        client = RemotePolicyClient(conn=c_end, request_timeout_s=WAIT_S)
        rng = np.random.default_rng(dist.get_rank())
        for _ in range(case["loop_requests"]):
            obs = rng.normal(size=(2,) + case["obs_shape"]).astype(np.float32)
            a, _, _ = client.act(obs, np.zeros(2, np.int32), np.zeros(2, np.float32),
                                 np.zeros(2, bool), ())
            actions.append(np.asarray(a))
        client.close()
    dist.barrier()
    flush_thread = server._threads[1]
    t0 = time.monotonic()
    if coord == 1:
        server.stop()
        ended = not flush_thread.is_alive()
    else:
        flush_thread.join(timeout=WAIT_S)
        ended = not flush_thread.is_alive()
        server.stop()
    return dict(actions=actions, pooled=pooled, flushes=server.flushes, ended=ended,
                stop_s=time.monotonic() - t0, accounting=server.accounting(),
                threads_alive=[t.is_alive() for t in server._threads])


def _act_msg(req_id, rng, obs_shape=(4,), lanes=2, obs_dtype=np.float32, reward_lanes=None):
    return {"kind": "act", "req": req_id,
            "obs": rng.normal(size=(lanes,) + tuple(obs_shape)).astype(obs_dtype),
            "last_action": np.zeros(lanes, np.int32),
            "reward": np.zeros(lanes if reward_lanes is None else reward_lanes, np.float32),
            "done": np.zeros(lanes, bool), "core": ()}


def _faults(case):
    """Ticks whose requests a lockstep flush cannot pool as they are, each
    pair driven tick by tick: requests refused at admission (a complex
    dtype, five dims a lane) beside the peer's good one; a batch that fails
    to pack on one rank (rewards for 3 of 2 lanes) beside the peer's good
    one; observations of different shapes on the two ranks; then a good
    tick on both.  Every reply by request id, each tick's verdict, and the
    collectives issued while admitting."""
    from scalerl_torch.serving import local_pair

    agent = _agent(case, case["spec"])
    server = _server(agent, case)
    coord = agent.mesh.coordinate("mp")
    rng = np.random.default_rng(dist.get_rank())
    pooled = []
    _recording(server, pooled)
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    if coord == 0:
        ticks = [[_act_msg(1, rng, obs_dtype=np.complex64), _act_msg(2, rng, (1, 1, 1, 1, 4))],
                 [_act_msg(3, rng, reward_lanes=3)],
                 [_act_msg(5, rng)],
                 [_act_msg(7, rng)]]
    else:
        ticks = [[_act_msg(11, rng)], [_act_msg(13, rng)], [_act_msg(15, rng, (5,))],
                 [_act_msg(17, rng)]]
    verdicts, replies, admit_collectives = [], {}, 0
    try:
        for msgs in ticks:
            with _Counted() as counted:
                for msg in msgs:
                    server._admit(s_end, msg)
            admit_collectives += counted.calls
            time.sleep(2 * case["serving"]["max_wait_s"])
            verdicts.append(server._tick(server.batcher.ready()))
            for _ in msgs:
                r = c_end.recv(timeout=WAIT_S)
                replies[r["req"]] = "error" if "error" in r else np.asarray(r["action"]).shape
    finally:
        server.hub.close()
    return dict(verdicts=verdicts, replies=replies, refused=server.refused,
                admit_collectives=admit_collectives, pooled=pooled, flushes=server.flushes,
                accounting=server.accounting())


def _failed_flush(case):
    """The flush threads of a pair, the second rank's pooled section
    failing before its first collective: its loop ends at once, and its
    peer, left waiting in that collective, fails after the groups' timeout
    (cut to ``case["group_timeout_s"]``) and ends too."""
    from scalerl_torch.serving import local_pair
    from scalerl_torch.serving import server as server_mod

    real_timeout = server_mod._GROUP_TIMEOUT_S
    server_mod._GROUP_TIMEOUT_S = case["group_timeout_s"]
    try:
        agent = _agent(case, case["spec"])
        server = _server(agent, case)
    finally:
        server_mod._GROUP_TIMEOUT_S = real_timeout
    coord = agent.mesh.coordinate("mp")
    if coord == 1:
        def broken(*a, **kw):
            raise RuntimeError("injected failure in the pooled section")

        server._act = broken
    c_end, s_end = local_pair()
    server.add_connection(s_end)
    server.start()
    t0 = time.monotonic()
    if coord == 0:
        c_end.send(_act_msg(21, np.random.default_rng(0)))
        reply = c_end.recv(timeout=WAIT_S)
    else:
        reply = None
    flush_thread = server._threads[1]
    flush_thread.join(timeout=WAIT_S)
    ended_s = time.monotonic() - t0
    ended = not flush_thread.is_alive()
    server.stop()
    return dict(reply_error=None if reply is None else reply.get("error"), ended=ended,
                ended_s=ended_s, group_error=repr(server.group_error),
                accounting=server.accounting())


def _trainer(case, workdir):
    """A few learn steps of the serving trainer with its learner at
    dp=2,mp=2: every rank's server holds its shards of the newest push."""
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.gym_env import make_vect_envs
    from scalerl_torch.parallel import sharding
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    rank = dist.get_rank()
    args = dataclasses.replace(case["trainer_args"], work_dir=workdir, seed=rank)
    agent = ImpalaAgent(args, case["obs_shape"], case["num_actions"], device="cpu")
    fns = [(lambda i=i: make_vect_envs("CartPole-v1", num_envs=2, seed=10 * rank + i,
                                       async_envs=False)) for i in range(2)]
    fallbacks = telemetry.get_registry().counter("serving_client.fallbacks").value
    trainer = HostActorLearnerTrainer(args, agent, fns, run_name="serving_mesh")
    server = trainer.inference_server
    try:
        result = trainer.train(total_frames=case["total_frames"])
    finally:
        trainer.close()
    shards = all(torch.equal(server._params[k], sharding.to_local(v))
                 for k, v in agent.state.params.items())
    return dict(learn_steps=trainer.learn_steps, generation=server.generation,
                loss=result["total_loss"], flushes=server.flushes,
                accounting=server.accounting(), shards_are_live=shards,
                sharded=sum(tuple(v.shape) != tuple(agent.get_weights()[k].shape)
                            for k, v in server._params.items()),
                fallbacks=telemetry.get_registry().counter("serving_client.fallbacks").value
                - fallbacks,
                threads_alive=any(t.is_alive() for t in server._threads))


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    results = {}
    for name, case in cases.items():
        try:
            if case["kind"] == "layout":
                results[name] = _layout(case)
            elif case["kind"] == "flushes":
                results[name] = _flushes(case)
            elif case["kind"] == "loop":
                results[name] = _loop(case)
            elif case["kind"] == "faults":
                results[name] = _faults(case)
            elif case["kind"] == "failed_flush":
                results[name] = _failed_flush(case)
            else:
                results[name] = _trainer(case, os.path.join(workdir, "run"))
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
