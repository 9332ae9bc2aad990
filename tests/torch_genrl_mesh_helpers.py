"""The ranks of the gloo world behind tests/test_torch_genrl_mesh.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group, runs every case of ``cases.pt`` (written by the test
module: the converted token-PPO state, the prompts and each case's mesh)
through the port's meshed engines, ``make_parallel_act_fn`` and
``SequenceRLTrainer``, and writes what it saw to ``rank<r>.pt``; the test
compares the ranks with each other and with the unmeshed references.
"""

import os
import time
import traceback

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


def _disagg(case):
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    try:
        DisaggSequenceRLTrainer(case["args"], agent=_agent(case), device="cpu")
    except ValueError as e:
        return {"refusal": str(e)}
    return {"refusal": None}


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
            else:
                results[name] = _disagg(case)
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
