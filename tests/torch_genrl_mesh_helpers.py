"""The ranks of the gloo world behind tests/test_torch_genrl_mesh.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group, runs every case of ``cases.pt`` (written by the test
module: the converted token-PPO state, the prompts and each case's mesh)
through the port's meshed engines, ``make_parallel_act_fn``,
``SequenceRLTrainer`` and ``DisaggSequenceRLTrainer``, and writes what it
saw to ``rank<r>.pt``; the test compares the ranks with each other and
with the unmeshed references.
"""

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from scalerl_torch.parallel.sharding import gather_tree
from scalerl_torch.utils.tree import tree_leaves, tree_map


def _full(tree):
    return tree_map(lambda x: x.detach().clone(), gather_tree(tree))


def _agent(case):
    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    agent = TokenPPOAgent(case["args"], build_genrl_model(case["args"], device="cpu"))
    agent.state = case["state"]
    return agent


def _completions(done):
    """Completed sequences by tag, as host arrays."""
    return {c.tag: dict(tokens=c.response_tokens, logp=c.behavior_logp, values=c.values)
            for c in done}


class _AheadClock:
    """The batcher's clock on a rank whose host clock runs ``ahead`` s
    before its mp partner's: on its own it would find every request past
    its admission deadline at once."""

    def __init__(self, ahead: float) -> None:
        self.ahead = ahead

    def monotonic(self) -> float:
        return time.monotonic() + self.ahead


def _continuous(agent, case, stagger=False, **kw):
    """A continuous engine on the agent's shards over the case's prompts,
    each step's carried logits, page table and bookkeeping recorded.  The
    second rank of each mp pair polls admission on a clock 1 s ahead.
    ``stagger``: two prompts first, then one a step, so requests wait out
    their admission deadline while other lanes decode."""
    from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
    from scalerl_torch.serving import batcher

    cfg = ContinuousConfig(**{**case["engine"], **kw})
    eng = ContinuousEngine(agent.model, agent.engine_weights(), cfg, device="cpu",
                           sync_guard=False, shard_ctx=agent.shard_ctx)
    queued = list(enumerate(zip(case["prompts"], case["lengths"])))
    first = 2 if stagger else len(queued)
    done, trace = [], []
    if agent.mesh.coordinate("mp"):
        batcher.time = _AheadClock(1.0)
    try:
        for step in range(200):
            if len(done) == len(case["prompts"]):
                break
            for i, (p, n) in queued[:first] if step == 0 else queued[first:][step - 1:step]:
                assert eng.submit(p, n, tag=i)
            done.extend(eng.step())
            trace.append(dict(logits=eng._logits_st.clone(), table=eng._table.copy(),
                              pages=eng.allocator.stats(), prefix=eng._prefix_cache.stats()))
    finally:
        batcher.time = time
    return dict(done=_completions(done), trace=trace, pool_shape=tuple(eng._pools.k[0].shape),
                prefix_saved=eng.prefix_tokens_saved, proposed=eng.spec_proposed_total)


def _engines(case):
    """Both engines on one agent's shards: greedy, sampled and speculative
    runs, and an int8 push."""
    from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine

    agent = _agent(case)
    agent.enable_mesh(case["spec"])
    out = {}
    for temp in (0.0, 1.0):
        cfg = GenerationConfig(**{**case["cohort"], "temperature": temp})
        eng = GenerationEngine(agent.model, agent.engine_weights(), cfg, device="cpu",
                               sync_guard=False, shard_ctx=agent.shard_ctx)
        res = eng.generate(case["prompts"], case["lengths"])
        out[f"cohort_t{temp:g}"] = res._asdict()
    out["continuous_t0"] = _continuous(agent, case, stagger=True, temperature=0.0)
    out["continuous_t1"] = _continuous(agent, case, temperature=1.0)
    out["spec_t1"] = _continuous(agent, case, temperature=1.0, spec_k=2, steps_in_flight=1)
    # an int8 push: each sharded leaf's scale is the whole leaf's
    eng.push_params(agent.engine_weights(), quantize="int8")
    full = agent.get_weights()
    out["int8"] = {k: (float(leaf.scale), float(full[k].abs().max() / 127.0),
                       tuple(leaf.q.shape), tuple(full[k].shape))
                   for k, leaf in eng._quantized.items() if hasattr(leaf, "scale")}
    return out


def _act(case):
    """make_parallel_act_fn on the token model: each rank's rows, gathered
    to the whole batch, and the DTensor leaves gathered in the call."""
    from torch.func import functional_call

    from scalerl_torch.parallel import sharding
    from scalerl_torch.parallel.logical import mp_param_spec
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.parallel.train_step import make_parallel_act_fn
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    model = build_genrl_model(case["args"], device="cpu")
    mesh = make_mesh(case["spec"])
    specs = (lambda p, x: mp_param_spec(p, x, mesh)) if case["rules"] == "mp" else None

    def act_fn(params, tokens):
        out = functional_call(model, params, (tokens,))
        return out.policy_logits, out.baseline

    params = case["state"].params
    act = make_parallel_act_fn(act_fn, mesh, params, param_specs=specs, modules=(model,))
    placed = act.shard_params(params)
    before = sharding.GATHER_STATS["dtensor_gathers"]
    logits, values = act(placed, act.shard_batch(case["tokens"]))
    gathers = sharding.GATHER_STATS["dtensor_gathers"] - before
    return dict(logits=sharding.gather_batch(logits, mesh), values=sharding.gather_batch(values, mesh),
                rows=logits.shape[0], dtensor_gathers=gathers,
                sharded=sum(bool(sharding.spec_of(x)) for x in placed.values()))


def _trainer(case):
    from scalerl_torch.genrl.task import TokenRecallTask
    from scalerl_torch.trainer import sequence_rl

    return sequence_rl.SequenceRLTrainer(case["args"], task=TokenRecallTask(**case["task"]),
                                         agent=_agent(case), device="cpu")


def _train(case):
    """Two rounds of the meshed trainer: each round's replay insert and
    metrics, the params after each, the replay at the end."""
    from scalerl_torch.trainer import sequence_rl

    inserts = []
    real_add = sequence_rl.seq_add

    def recording(state, fields, core, priorities):
        inserts.append(({k: v.clone() for k, v in fields.items()}, priorities.clone()))
        return real_add(state, fields, core, priorities)

    sequence_rl.seq_add = recording
    try:
        t = _trainer(case)
        metrics, params = [], []
        for _ in range(2):
            metrics.append(t.train_round())
            params.append(_full(t.agent.state.params))
    finally:
        sequence_rl.seq_add = real_add
    return dict(inserts=inserts, metrics=metrics, params=params,
                replay={k: v.clone() for k, v in t.replay.storage.items()},
                priorities=t.replay.priorities.clone(), shape=dict(t.agent.mesh.shape),
                pool_heads=t.engine._run.heads, guard=t.engine._sync_guard,
                batch_mode=t.agent._learn.batch_mode)


def _resume(case, workdir):
    """A round, a save, a round; a fresh trainer loads the save and takes
    the second round again: both must end bit for bit alike."""
    path = os.path.join(workdir, "genrl_ckpt")
    t = _trainer(case)
    t.train(1)
    t.save_checkpoint(path)
    unbroken = t.train_round()
    want = _full(t.agent.state)
    other = _trainer(case)  # from the initial state, an empty replay, fresh streams
    other.load_checkpoint(path)
    resumed = other.train_round()
    got = _full(other.agent.state)
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(want), tree_leaves(got)))
    return dict(equal=equal, metrics=(unbroken, resumed), steps=(t.learn_steps, other.learn_steps),
                generation=(t.engine.generation, other.engine.generation))


class _PreemptedOnRank1:
    """A preemption guard that only rank 1 sees tripped."""

    def poll_chaos(self, site: str) -> bool:
        return dist.get_rank() == 1


def _stops(case, workdir):
    """Stop and save agreed across ranks: rank 0 alone runs out of its time
    window (0 s), rank 1 alone sees a preemption; every rank stops before
    its first round, and the preempted run saves."""
    t = _trainer(case)
    window = t.train(3, seconds=0.0 if dist.get_rank() == 0 else 1e9)
    path = os.path.join(workdir, "preempted")
    preempted = t.train(3, guard=_PreemptedOnRank1(), save_path=path)
    return dict(rounds=(window["rounds"], preempted["rounds"]), steps=t.learn_steps,
                saved=os.path.isdir(os.path.join(path, "agent")))


def _disagg_trainer(case, **kw):
    from scalerl_torch.genrl.disagg import ScriptedEngineFactory
    from scalerl_torch.genrl.task import TokenRecallTask
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    factory = kw.pop("engine_factory", None) or ScriptedEngineFactory(**case["scripted"])
    return DisaggSequenceRLTrainer(case["args"], task=TokenRecallTask(**case["task"]),
                                   agent=_agent(case), engine_factory=factory, device="cpu", **kw)


def _disagg(case):
    """Two rounds of the disaggregated trainer, its scripted thread hosts on
    rank 0: each round's replay insert and metrics, the params after each,
    the replay at the end, and who owns the fleet."""
    from scalerl_torch.trainer import sequence_rl

    inserts = []
    real_add = sequence_rl.seq_add

    def recording(state, fields, core, priorities):
        inserts.append(({k: v.clone() for k, v in fields.items()}, priorities.clone()))
        return real_add(state, fields, core, priorities)

    sequence_rl.seq_add = recording
    try:
        t = _disagg_trainer(case)
        try:
            metrics, params = [], []
            for _ in range(2):
                metrics.append(t.train_round())
                params.append(_full(t.agent.state.params))
        finally:
            t.close()
    finally:
        sequence_rl.seq_add = real_add
    return dict(inserts=inserts, metrics=metrics, params=params,
                replay={k: v.clone() for k, v in t.replay.storage.items()},
                priorities=t.replay.priorities.clone(), owns_fleet=t.owns_fleet,
                learner=t.learner is not None, fleet=t.fleet is not None,
                generation=None if t.learner is None else t.learner.generation,
                batch_mode=t.agent._learn.batch_mode)


def _disagg_kill(case):
    """A mass_kill wave on rank 0's spawned scripted hosts after the first
    round; rounds go on (every rank alike, as rank 0 says) until every
    lease issued before the wave has been learned from: how many never
    arrived (``lost``) and how many twice."""
    from scalerl_torch.parallel.collectives import broadcast_int
    from scalerl_torch.runtime import chaos

    t = _disagg_trainer(case, use_threads=False)
    seeds = []
    try:
        if t.owns_fleet:
            real_get = t.learner.get_sequence

            def recording(timeout=None):
                payload = real_get(timeout=timeout)
                if payload is not None:
                    seeds.append(int(payload["seed"]))
                return payload

            t.learner.get_sequence = recording
        metrics = [t.train_round()]
        killed, cut = [], 0
        if t.owns_fleet:
            os.environ[chaos.ENV_VAR] = case["chaos"]
            chaos.clear()
            try:
                killed = t.fleet.chaos_poll()
            finally:
                del os.environ[chaos.ENV_VAR]
                chaos.clear()
            cut = t._lease_seq
        for _ in range(case["max_rounds"]):
            if broadcast_int(int(t.owns_fleet and set(range(1, cut + 1)) <= set(seeds)), "cpu"):
                break
            metrics.append(t.train_round())
        requeued = t.learner.requeued_leases if t.owns_fleet else None
        dropped = t.learner.dropped_sequences if t.owns_fleet else None
    finally:
        t.close()
    return dict(killed=len(killed), cut=cut, lost=len(set(range(1, cut + 1)) - set(seeds)),
                duplicates=len(seeds) - len(set(seeds)), requeued=requeued, dropped=dropped,
                rounds=len(metrics), steps=t.learn_steps,
                losses=[m["total_loss"] for m in metrics])


class _PreemptedOnRank1After:
    """A preemption guard that only rank 1 sees tripped, at its
    ``rounds + 1``-th poll."""

    def __init__(self, rounds: int) -> None:
        self.polls, self.rounds = 0, rounds

    def poll_chaos(self, site: str) -> bool:
        self.polls += 1
        return dist.get_rank() == 1 and self.polls > self.rounds


def _disagg_resume(case, workdir):
    """Two rounds, then a preemption seen on rank 1 alone: every rank
    gathers the weights into rank 0's ledger, the one frame written.  A new
    trainer against the same ledger resumes at the same learn step under
    epoch 2 on every rank, with the same params (in the learner's layout),
    replay and sampler, and takes another round."""
    from scalerl_torch.data.sequence_replay import seq_export

    ledger = os.path.join(workdir, "disagg_ledger")
    t = _disagg_trainer(case, ledger_dir=ledger, guard=_PreemptedOnRank1After(2))
    summary = t.train(4)
    cut = dict(params=_full(t.agent.state.params), replay=seq_export(t.replay),
               sampler=t._sample_generator.get_state().clone())
    r = _disagg_trainer(case, ledger_dir=ledger)
    try:
        resumed = dict(steps=r.learn_steps, epoch=r.learner_epoch,
                       params_equal=all(torch.equal(a, b) for a, b in zip(
                           tree_leaves(cut["params"]), tree_leaves(_full(r.agent.state.params)))),
                       layout_equal=all(
                           type(a) is type(b) and a.shape == b.shape
                           and getattr(a, "placements", None) == getattr(b, "placements", None)
                           for a, b in zip(tree_leaves(t.agent.state.params),
                                           tree_leaves(r.agent.state.params))),
                       replay_equal=all(np.array_equal(v, seq_export(r.replay)["storage"][k])
                                        for k, v in cut["replay"]["storage"].items()),
                       sampler_equal=torch.equal(cut["sampler"], r._sample_generator.get_state()),
                       rewards=list(r.reward_history))
        after = r.train_round()
    finally:
        r.close()
    return dict(rounds=summary["rounds"], steps=summary["learn_steps"], resumed=resumed,
                steps_after=r.learn_steps, loss_after=after["total_loss"],
                saved=sorted(os.listdir(ledger)))


def _disagg_window(case):
    """Rank 0 alone runs out of its time window (0 s): every rank stops
    before its first round, and rank 0's fleet is closed."""
    t = _disagg_trainer(case)
    summary = t.train(3, seconds=0.0 if dist.get_rank() == 0 else 1e9)
    return dict(rounds=summary["rounds"], steps=t.learn_steps,
                stopped=None if t.learner is None else t.learner.stopped)


class _IdleFactory:
    """Hosts whose engines never admit a lease."""

    def __call__(self, params, generation):
        from scalerl_torch.genrl.disagg import ScriptedSequenceEngine

        eng = ScriptedSequenceEngine()
        eng.capacity = lambda: 0
        return eng


def _disagg_starved(case):
    t = _disagg_trainer(case, engine_factory=_IdleFactory())
    try:
        t.train(1)
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


class _ScoreFails:
    """A task whose scoring raises: the drain of rank 0 fails past the
    starvation check."""

    def __init__(self, task):
        self._task = task

    def __getattr__(self, name):
        return getattr(self._task, name)

    def score(self, *args, **kwargs):
        raise ValueError("injected scoring failure")


def _disagg_drain_error(case):
    """Rank 0's scoring raises: every rank raises the same error."""
    t = _disagg_trainer(case)
    if dist.get_rank() == 0:
        t.task = _ScoreFails(t.task)
    try:
        t.train(1)
    except RuntimeError as e:
        return {"raised": str(e), "steps": t.learn_steps}
    return {"raised": None, "steps": t.learn_steps}


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    results = {}
    for name, case in cases.items():
        try:
            kind = case["kind"]
            if kind == "engines":
                results[name] = _engines(case)
            elif kind == "act":
                results[name] = _act(case)
            elif kind == "train":
                results[name] = _train(case)
            elif kind == "resume":
                results[name] = _resume(case, workdir)
            elif kind == "stops":
                results[name] = _stops(case, workdir)
            elif kind == "disagg":
                results[name] = _disagg(case)
            elif kind == "disagg_kill":
                results[name] = _disagg_kill(case)
            elif kind == "disagg_resume":
                results[name] = _disagg_resume(case, workdir)
            elif kind == "disagg_window":
                results[name] = _disagg_window(case)
            elif kind == "disagg_drain_error":
                results[name] = _disagg_drain_error(case)
            else:
                results[name] = _disagg_starved(case)
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
