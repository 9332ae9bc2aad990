"""The host surface of a policy-value agent (IMPALA's, in the port).

Port of the host half of ``scalerl_tpu/agents/policy_value.py::
PolicyValueAgent``: ``initial_state``, a thread-safe ``act`` for actor
threads, ``get_action``/``predict`` with a carried recurrent core, and
checkpoints.  A subclass sets ``model``, ``state`` (with ``params``),
``device`` and ``num_actions`` and calls :meth:`_setup_host`.

Several actor threads call :meth:`act` while the learner thread trains:

- the learn step builds new parameter tensors and the agent swaps
  ``self.state`` in one assignment, so an actor reads either the old or
  the new parameters, never a half-written mix;
- ``torch.func.functional_call`` runs a model by swapping the module's
  parameters in place for the call, which two threads must not do to one
  module: each thread acts through its own copy of the model (made at its
  first act, from a template nobody runs), and the learner keeps
  ``self.model``;
- the sampling generator is drawn from under a lock (the reference's
  ``_key_lock``): unguarded, two actors could take the same draws.

:meth:`act` on host (numpy) inputs makes one host-to-device copy of the
step's inputs (the frames, last actions, rewards and done flags packed into
one byte buffer) and one device-to-host copy of the actions and logits,
which it returns as numpy; on tensors it returns tensors on the device.
A core given as numpy (one an inference server answered with, when the
agent is a serving client's local fallback) goes up in one more copy.

:meth:`PolicyValueAgent.enable_mesh` shards the learn step over a mesh
(``parallel/train_step.py``): the batch over ``dp`` x ``fsdp``, the state by
the heuristic fsdp/tp rule, or under ``mp > 1`` by the logical rule table
of ``parallel/logical.py`` (the transformer policy, whose activation seam
``constrain`` gets ``activation_constraint``).  A meshed agent acts on its
params gathered to full tensors once a learn step
(``parallel/sharding.py::MeshedAgentState``).
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed
from torch.func import functional_call

from scalerl_torch.agents.base import BaseAgent, RecurrentEvalState


def sample_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One action per row of ``logits`` by the Gumbel-max trick, on the
    device and without a host sync (``torch.multinomial`` checks its input
    on the host)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def pack_to_device(arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """Host arrays -> device tensors of the same dtypes and shapes with ONE
    host-to-device copy: their bytes, each padded to 4, in one ``uint8``
    buffer cut into typed views on the device."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += a.nbytes + (-a.nbytes) % 4
    buf = np.empty(total, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).reshape(a.shape)
            for a, o in zip(arrays, offsets)]


def pack_host_inputs(obs, last_action, reward, done, device: torch.device):
    """One acting step's host inputs -> device tensors with one copy
    (:func:`pack_to_device`): the frames, int32 last actions, float32
    rewards and bool done flags."""
    B = np.asarray(obs).shape[0]
    return tuple(pack_to_device([
        np.asarray(obs),
        np.asarray(last_action, np.int32).reshape(B),
        np.asarray(reward, np.float32).reshape(B),
        np.asarray(done, bool).reshape(B),
    ], device))


class PolicyValueAgent(BaseAgent):
    """Host-facing agent over a recurrent policy-value model."""

    model: torch.nn.Module
    device: torch.device
    num_actions: int

    _shard_batch = None
    # False keeps the whole batch on every rank under a mesh (PPO: its
    # minibatch shuffle spans the lanes of the whole batch)
    _split_batch = True

    def _setup_host(self, seed: int) -> None:
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._gen_lock = threading.Lock()
        # actor threads copy this module, taken at the first act; it is
        # never run, so never swapped
        self._act_template = None
        self._template_lock = threading.Lock()
        self._local = threading.local()
        self._eval_state = RecurrentEvalState(self.initial_state)

    # ------------------------------------------------------------------
    def initial_state(self, batch_size: int):
        return self.model.initial_state(batch_size)

    def _thread_model(self) -> torch.nn.Module:
        model = getattr(self._local, "model", None)
        if model is None:
            with self._template_lock:
                if self._act_template is None:
                    self._act_template = copy.deepcopy(self.model)
                model = copy.deepcopy(self._act_template)
            self._local.model = model
        return model

    def _forward(self, obs, last_action, reward, done, core_state):
        params = self.acting_params()  # one read: the learner swaps the state whole
        out, new_core = functional_call(
            self._thread_model(), params,
            (obs[None], last_action[None], reward[None], done[None], core_state),
        )
        return out.policy_logits[0], new_core

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        with self._gen_lock:
            return sample_categorical(logits, self.generator)

    @torch.no_grad()
    def act(self, obs, last_action, reward, done, core_state=()) -> Tuple[Any, Any, Any]:
        """One acting step over ``[B, ...]`` lanes -> ``(actions, logits,
        core)``: numpy actions (int32) and logits for numpy inputs, device
        tensors for tensor inputs; the core stays on the device."""
        if isinstance(obs, torch.Tensor):
            logits, new_core = self._forward(obs, last_action, reward, done, core_state)
            return self._sample(logits), logits, new_core
        inputs = pack_host_inputs(obs, last_action, reward, done, self.device)
        if core_state and not isinstance(core_state[0][0], torch.Tensor):
            # a host core (one the inference server answered with, when this
            # agent stands in as a serving client's fallback)
            core_state = tuple(pack_to_device([np.asarray(c, np.float32) for pair in core_state
                                               for c in pair], self.device))
            core_state = tuple(zip(core_state[0::2], core_state[1::2]))
        logits, new_core = self._forward(*inputs, core_state)
        action = self._sample(logits)
        host = torch.cat([logits.float(), action[:, None].float()], dim=1).cpu().numpy()
        return host[:, -1].astype(np.int32), host[:, :-1], new_core

    @torch.no_grad()
    def _greedy(self, obs, last_action, reward, done, core_state):
        inputs = pack_host_inputs(obs, last_action, reward, done, self.device)
        logits, new_core = self._forward(*inputs, core_state)
        return logits.argmax(-1).cpu().numpy().astype(np.int32), new_core

    def get_action(self, obs, *, done=None) -> np.ndarray:
        """Sampled actions with a persistent recurrent core (rows reset where
        the previous step's ``done`` is True)."""
        B = np.asarray(obs).shape[0]
        core, prev_a, prev_r, done_in = self._eval_state.step_inputs("explore", B, done)
        a, _, new_core = self.act(np.asarray(obs), prev_a, prev_r, done_in, core)
        self._eval_state.update("explore", a, new_core)
        return a

    def predict(self, obs, *, done=None) -> np.ndarray:
        """Greedy actions, with the same persistent core as ``get_action``."""
        B = np.asarray(obs).shape[0]
        core, prev_a, prev_r, done_in = self._eval_state.step_inputs("greedy", B, done)
        a, new_core = self._greedy(np.asarray(obs), prev_a, prev_r, done_in, core)
        self._eval_state.update("greedy", a, new_core)
        return a

    def load_checkpoint(self, path: str) -> None:
        super().load_checkpoint(path)
        self._eval_state.reset()  # a carried core came from the old weights

    # ------------------------------------------------------------------
    def enable_mesh(self, mesh_or_spec, batch_example=None) -> None:
        """Shard the learn step over a mesh (``mesh_shape`` or ``dp_size`` x
        ``mp_size``); call once, before training.  A mesh with ``mp > 1``
        needs a model the logical rule table knows (the transformer or
        MoE policy) and lays the state out by it; any other mesh keeps the
        heuristic fsdp/tp layout."""
        from scalerl_torch.parallel.logical import (
            activation_constraint,
            has_mp_params,
            mp_param_spec,
        )
        from scalerl_torch.parallel.mesh import resolve_mesh
        from scalerl_torch.parallel.train_step import make_parallel_learn_fn, multi_rank

        mesh = resolve_mesh(mesh_or_spec)
        if not self._split_batch and multi_rank(mesh):
            # every rank computes the whole update, so its seeded draws
            # (PPO's lane shuffle) take rank 0's seed on every rank
            seed = [self.args.seed]
            torch.distributed.broadcast_object_list(seed, src=0)
            self.args = dataclasses.replace(self.args, seed=seed[0])
        spec_fn = None
        if mesh.shape["mp"] > 1:
            if not has_mp_params(self.state.params):
                raise ValueError(
                    "mesh has mp > 1 but this agent's model has no model-parallel sharding "
                    "rules: use a transformer or MoE policy (policy_arch='transformer' or "
                    "'moe') or a pure-dp mesh")
            inner = getattr(self.model, "transformer", getattr(self.model, "moe_policy", None))
            if inner is not None and inner.constrain is None:
                inner.constrain = activation_constraint(mesh)
            spec_fn = lambda path, x: mp_param_spec(path, x, mesh)  # noqa: E731
        plearn = make_parallel_learn_fn(self.make_learn_fn(), mesh, self.state,
                                        batch_example=batch_example, param_specs=spec_fn,
                                        split_batch=self._split_batch, modules=(self.model,))
        self.mesh = mesh
        self.state = plearn.shard_state(self.state)
        self._learn = plearn
        self._shard_batch = plearn.shard_batch

    def _learn_step(self, *batch):
        """One update of ``self.state`` on ``batch`` (this rank's rows of it
        under a mesh); returns the learn function's other outputs."""
        if self._shard_batch is not None:
            batch = tuple(self._shard_batch(b) for b in batch)
        out = self._learn(self.state, *batch)
        self.state = out[0]
        return out[1:]

    def get_weights(self):
        return self.acting_params()
