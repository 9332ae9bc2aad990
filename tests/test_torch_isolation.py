"""The PyTorch port stands alone and never hides a missing card.

- Importing ``scalerl_torch`` and every submodule loads no JAX and nothing
  of ``scalerl_tpu``; no source of the port (nor ``chip_smoke.py``) names
  them in an import.
- The entry points default to ``device="cuda"`` and raise without a card
  instead of running on the host.
- A spawned env worker of the port loads neither JAX nor the JAX package,
  nor initializes CUDA; nor do the spawned actors of the process plane
  (parallel DQN and process-actor IMPALA).
- ``chip_smoke.py`` fails, printing no result, without a card, and in a
  directory that holds nothing else of the repo.
"""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import scalerl_torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scalerl_tpu")


def _submodules():
    return sorted(
        m.name for m in pkgutil.walk_packages(scalerl_torch.__path__, "scalerl_torch.")
    )


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['scalerl_torch'] + _submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the IMPALA, DQN, generation, sequence-RL training, replay and process-plane
    # slices, the remaining learners (A3C, PPO, IMPACT, SAC, TD3), the
    # serving plane (server, client, router, hub, attribution), the fleet
    # (cluster, generation, autoscaler, the multi-agent env and vector envs),
    # and the rest of sequence RL (quantize, drafter, ledger, disagg)
    assert len(_submodules()) >= 120
    for name in ("scalerl_torch.runtime.quantize", "scalerl_torch.genrl.drafter",
                 "scalerl_torch.genrl.ledger", "scalerl_torch.genrl.disagg"):
        assert name in _submodules()


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_source_imports_jax():
    sources = sorted((REPO / "scalerl_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "torch_learning_curves.py",
        REPO / "examples" / "train_impala_torch.py", REPO / "examples" / "train_dqn_torch.py",
        REPO / "examples" / "train_apex_torch.py", REPO / "examples" / "train_r2d2_torch.py",
        REPO / "examples" / "train_parallel_dqn_torch.py", REPO / "tests" / "torch_ring_helpers.py",
        *(REPO / "examples" / f"train_{n}_torch.py" for n in ("a3c", "ppo", "impact", "sac", "td3",
                                                               "fleet_impala", "fleet_dqn",
                                                               "a3c_fleet", "marl_dqn")),
        REPO / "tests" / "torch_fleet_helpers.py", REPO / "tests" / "torch_family_helpers.py"]
    for path in sources:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.models.atari import AtariNet
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ImpalaArguments(use_lstm=False, hidden_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticPixelEnv(num_envs=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ImpalaAgent(args, (84, 84, 4), 6)
    with pytest.raises(RuntimeError, match="cuda"):
        AtariNet(num_actions=6, use_lstm=False)
    env = SyntheticPixelEnv(num_envs=2, device="cpu")
    agent = ImpalaAgent(args, env.observation_shape, env.num_actions, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), unroll_length=2)


def test_dqn_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.data.prioritized import PrioritizedReplayBuffer
    from scalerl_torch.data.replay import ReplayBuffer
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.models.mlp import QNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: DQNAgent(DQNArguments(), (4,), 2),
        lambda: TensorCartPole(num_envs=2),
        lambda: QNet((4,), 2),
        lambda: ReplayBuffer((4,), 8),
        lambda: PrioritizedReplayBuffer((4,), 8),
        lambda: Sampler((4,), 8, use_per=True, use_pallas=True),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_generation_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
    from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine
    from scalerl_torch.models.transformer import (
        TransformerPolicy,
        init_kv_cache,
        init_paged_kv_cache,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(num_actions=11, vocab_size=11, d_model=16, num_heads=2, num_layers=1, max_len=32)
    for make in (
        lambda: TransformerPolicy(**kw),
        lambda: init_kv_cache(2, 8, 1, 2, 8),
        lambda: init_paged_kv_cache(5, 4, 1, 2, 8),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert init_kv_cache(2, 8, 1, 2, 8, device="cpu").k[0].device.type == "cpu"
    model = TransformerPolicy(**kw, device="cpu")
    cfg = dict(vocab_size=11, max_prompt_len=4, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="cuda"):
        GenerationEngine(model, model.state_dict(), GenerationConfig(**cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousEngine(model, model.state_dict(), ContinuousConfig(**cfg, lanes=2))


def test_transformer_learner_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.models.transformer_policy import TransformerPolicyNet, build_mp_policy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ImpalaArguments(policy_arch="transformer", d_model=16, n_heads=2, n_layers=1,
                           rollout_length=4, batch_size=2, use_lstm=False, bf16_params=True,
                           use_pallas=True)
    for make in (
        lambda: TransformerPolicyNet(3, (8,), d_model=16, num_heads=2, num_layers=1),
        lambda: build_mp_policy(args, (8,), 3),
        lambda: ImpalaAgent(args, (8,), 3),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    ImpalaAgent(args, (8,), 3, device="cpu")


def test_mesh_family_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.models.moe import MoEMLP, MoEPolicyNet
    from scalerl_torch.parallel import initialize_multihost, make_expert_parallel_apply, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    model = MoEMLP(4, 8, 16, device="cpu")
    for make in (
        lambda: initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=1,
                                     process_id=0),
        lambda: make_expert_parallel_apply(model, make_mesh("ep=1")),
        lambda: MoEMLP(4, 8, 16),
        lambda: MoEPolicyNet(3, (8,)),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    apply_fn, params = make_expert_parallel_apply(model, make_mesh("ep=1"), device="cpu")
    assert apply_fn(params, torch.zeros(5, 8)).out.shape == (5, 8)


def test_learning_slice_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.envs.tensor_envs import (
        TensorBreakout,
        TensorCatch,
        TensorRecall,
        make_tensor_vec_env,
    )
    from scalerl_torch.models.atari import AtariNet
    from scalerl_torch.models.policy import MLPPolicyNet
    from tools import torch_learning_curves

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: TensorCatch(num_envs=2),
        lambda: TensorRecall(num_envs=2),
        lambda: TensorBreakout(num_envs=2),
        lambda: make_tensor_vec_env("Catch-v0", 2),
        lambda: MLPPolicyNet(3, 4),
        lambda: AtariNet(num_actions=6, use_lstm=True),
        lambda: torch_learning_curves.impala_catch(),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert torch_learning_curves.main(["--tasks", "catch", "--seeds", "0"]) == 1


def test_sequence_rl_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.config import GenRLArguments
    from scalerl_torch.data.sequence_replay import seq_import, seq_init
    from scalerl_torch.trainer.sequence_rl import SequenceRLTrainer, build_genrl_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = GenRLArguments()
    for make in (
        lambda: SequenceRLTrainer(args),
        lambda: build_genrl_model(args),
        lambda: seq_init({"x": ((2,), torch.float32)}, (), 4),
        lambda: seq_import({"storage": {}, "core": (), "priorities": [0.0], "pos": 0, "size": 0}),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    SequenceRLTrainer(args, device="cpu").train_round()


def test_disaggregated_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    """The disaggregated trainer and the real-engine host factories default
    to the card; a wire snapshot reaches a real engine only as tensors on
    its device (numpy params are refused)."""
    from scalerl_torch.config import GenRLArguments
    from scalerl_torch.genrl.disagg import upload_wire_params
    from scalerl_torch.trainer.sequence_rl import (
        DisaggSequenceRLTrainer,
        _CohortShellFactory,
        _ContinuousShellFactory,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = GenRLArguments(vocab_size=12, prompt_len=4, max_new_tokens=4, d_model=16, n_layers=1,
                          n_heads=2, genrl_batch=4, genrl_sample_batch=4,
                          genrl_buffer_sequences=8)
    wire = {k: v.numpy() for k, v in _tiny_token_model().state_dict().items()}
    for make in (
        lambda: DisaggSequenceRLTrainer(args),
        lambda: _CohortShellFactory(args, 2)(wire, 1),
        lambda: _ContinuousShellFactory(args, 2)(wire, 1),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises(TypeError, match="float32"):
        upload_wire_params({k: torch.from_numpy(v) for k, v in wire.items()},
                           torch.device("cpu"))
    shell = _CohortShellFactory(args, 2, device="cpu")(wire, 1)
    assert shell.engine.device.type == "cpu" and shell.generation == 1


def _tiny_token_model():
    from scalerl_torch.config import GenRLArguments
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    return build_genrl_model(GenRLArguments(vocab_size=12, prompt_len=4, max_new_tokens=4,
                                            d_model=16, n_layers=1, n_heads=2), device="cpu")


def test_actor_learner_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    import importlib.util

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.envs.tensor_envs import make_tensor_vec_env
    from scalerl_torch.trainer.actor_learner import (
        DeviceActorLearnerTrainer,
        HostActorLearnerTrainer,
    )
    from tools import torch_learning_curves

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(
        "train_impala_torch", REPO / "examples" / "train_impala_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = ImpalaArguments(use_lstm=False, hidden_size=16, logger_backend="none",
                           telemetry_interval_s=0.0, save_model=False, work_dir="/nonexistent")
    for make in (
        lambda: make_tensor_vec_env("CartPole-v1", 4),
        lambda: ImpalaAgent(args, (4,), 2),
        lambda: DeviceActorLearnerTrainer(args, ImpalaAgent(args, (4,), 2),
                                          make_tensor_vec_env("CartPole-v1", 4)),
        lambda: HostActorLearnerTrainer(args, ImpalaAgent(args, (4,), 2), []),
        lambda: example.main(["--env-backend", "jax", "--env-id", "CartPole-v1"]),
        lambda: example.main(["--env-id", "CartPole-v1"]),
        lambda: torch_learning_curves.impala_cartpole_host(),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_replay_family_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import DQNArguments, R2D2Arguments
    from scalerl_torch.envs.tensor_envs import TensorRecall
    from scalerl_torch.models.mlp import C51QNet
    from scalerl_torch.models.recurrent_q import RecurrentQNet
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer
    from tools import torch_learning_curves

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    quiet = ["--logger-backend", "none", "--telemetry-interval-s", "0", "--save-model", "false",
             "--work-dir", "/nonexistent"]
    r2d2 = R2D2Arguments(hidden_size=8, logger_backend="none", telemetry_interval_s=0.0,
                         save_model=False, work_dir="/nonexistent")
    for make in (
        lambda: DQNAgent(DQNArguments(categorical_dqn=True, noisy_dqn=True), (4,), 2),
        lambda: C51QNet((4,), 2, 11, noisy=True),
        lambda: RecurrentQNet((12, 12, 1), 2),
        lambda: R2D2Agent(r2d2, (5,), 2),
        lambda: DeviceR2D2Trainer(r2d2, R2D2Agent(r2d2, (12, 12, 1), 2), TensorRecall(2)),
        lambda: _example("train_dqn_torch").main(["--env-backend", "jax"] + quiet),
        lambda: _example("train_apex_torch").main(["--env-backend", "jax"] + quiet),
        lambda: _example("train_r2d2_torch").main(["--env-id", "RecallGym-v0"] + quiet),
        lambda: _example("train_r2d2_torch").main(["--env-backend", "jax", "--env-id",
                                                   "Recall-v0"] + quiet),
        lambda: torch_learning_curves.dqn_cartpole(work_dir="/nonexistent"),
        lambda: torch_learning_curves.r2d2_recall_device(work_dir="/nonexistent"),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_process_plane_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    quiet = ["--logger-backend", "none", "--telemetry-interval-s", "0", "--save-model", "false",
             "--work-dir", "/nonexistent"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: _example("train_parallel_dqn_torch").main(["--env-backend", "jax"] + quiet),
        lambda: _example("train_impala_torch").main(["--actor-mode", "process", "--env-id",
                                                     "PixelRing-v0"] + quiet),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_serving_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.serving import InferenceServer

    quiet = ["--logger-backend", "none", "--telemetry-interval-s", "0", "--save-model", "false",
             "--work-dir", "/nonexistent"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _example("train_impala_torch").main(["--actor-mode", "serving", "--env-id",
                                             "PixelRing-v0"] + quiet)
    # the server lives on its agent's device, which the caller chose
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments

    agent = ImpalaAgent(ImpalaArguments(use_lstm=False, hidden_size=8), (4,), 2, device="cpu")
    server = InferenceServer(agent)
    try:
        assert server.device.type == "cpu" and server._generator.device.type == "cpu"
    finally:
        server.stop()


def test_remaining_learners_entry_points_refuse_the_default_device_without_a_card(monkeypatch):
    from scalerl_torch.agents.a3c import A3CAgent
    from scalerl_torch.agents.impact import ImpactAgent
    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.agents.td3 import TD3Agent
    from scalerl_torch.config import (
        A3CArguments,
        ImpactArguments,
        PPOArguments,
        SACArguments,
        TD3Arguments,
    )
    from scalerl_torch.models.mlp import (
        ActorCriticNet,
        ActorNet,
        CriticNet,
        DeterministicActor,
        TanhGaussianActor,
        TwinQNet,
    )
    from tools import torch_learning_curves

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    quiet = ["--logger-backend", "none", "--telemetry-interval-s", "0", "--save-model", "false",
             "--work-dir", "/nonexistent"]
    cartpole = ["--env-backend", "jax", "--env-id", "CartPole-v1"] + quiet
    box = (np.array([-2.0], np.float32), np.array([2.0], np.float32))
    for make in (
        lambda: A3CAgent(A3CArguments(), (4,), 2),
        lambda: PPOAgent(PPOArguments(), (84, 84, 4), 6),
        lambda: ImpactAgent(ImpactArguments(use_lstm=False, hidden_size=8), (4,), 2),
        lambda: SACAgent(SACArguments(), (3,), *box),
        lambda: TD3Agent(TD3Arguments(), (3,), *box),
        lambda: ActorNet(4, 2),
        lambda: CriticNet(4),
        lambda: ActorCriticNet(4, 2),
        lambda: TanhGaussianActor(3, 1),
        lambda: DeterministicActor(3, 1),
        lambda: TwinQNet(3, 1),
        lambda: _example("train_a3c_torch").main(cartpole),
        lambda: _example("train_ppo_torch").main(cartpole),
        lambda: _example("train_impact_torch").main(cartpole + ["--use-lstm", "false"]),
        lambda: _example("train_sac_torch").main(quiet),
        lambda: _example("train_td3_torch").main(quiet),
        lambda: torch_learning_curves.a3c_cartpole(work_dir="/nonexistent"),
        lambda: torch_learning_curves.ppo_recall_lstm(),
        lambda: torch_learning_curves.sac_pendulum(work_dir="/nonexistent"),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_spawned_process_plane_actors_load_no_jax_and_no_cuda(tmp_path):
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import DQNArguments, ImpalaArguments
    from scalerl_torch.trainer.parallel_dqn import ParallelDQNTrainer
    from scalerl_torch.trainer.process_actor_learner import ProcessActorLearnerTrainer

    quiet = dict(logger_backend="none", telemetry_interval_s=0.0, save_model=False,
                 work_dir=str(tmp_path))
    dqn_args = DQNArguments(hidden_sizes="8", warmup_learn_steps=40, env_backend="jax", **quiet)
    dqn = ParallelDQNTrainer(dqn_args, DQNAgent(dqn_args, (4,), 2, device="cpu"), "CartPole-v1",
                             (4,), num_actors=2, num_slots=4)
    dqn.train(total_steps=400)
    impala_args = ImpalaArguments(env_id="PixelRing-v0", num_envs=2, num_actors=2,
                                  num_buffers=4, rollout_length=4, batch_size=2,
                                  use_lstm=False, hidden_size=8, **quiet)
    impala = ProcessActorLearnerTrainer(impala_args, ImpalaAgent(impala_args, (84, 84, 4), 6,
                                                                 device="cpu"))
    impala.train(total_frames=32)
    for trainer in (dqn, impala):
        assert trainer.child_reports and all(not p.is_alive() for p in trainer.procs)
        for report in trainer.child_reports.values():
            assert report["cuda_initialized"] is False
            assert "scalerl_torch" in report["modules"]
            assert not set(FORBIDDEN) & set(report["modules"])
        trainer.close()


def test_spawned_env_workers_load_no_jax_and_no_cuda():
    import gymnasium as gym
    import numpy as np

    from scalerl_torch.envs.gym_env import make_vect_envs

    envs = make_vect_envs("torch_env_probe:ModulesEnv", num_envs=2, seed=0, async_envs=True)
    try:
        assert isinstance(envs, gym.vector.AsyncVectorEnv)
        envs.reset(seed=0)
        envs.step(np.zeros(2, np.int64))
        for roots in envs.get_attr("loaded_roots"):
            assert "scalerl_torch" in roots and not set(FORBIDDEN) & set(roots)
        assert envs.get_attr("cuda_initialized") == (False, False)
    finally:
        envs.close()


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
