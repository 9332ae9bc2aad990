"""IMPALA training on PyTorch: the twin of ``examples/train_impala.py``.

Two backends, as in the JAX package's entry point:

- ``--env-backend jax``: the fused actor-learner loop over the port's tensor
  envs on the card (``CartPole-v1``, ``SyntheticPixel-v0``, ``Catch-v0``,
  ``Recall-v0``, ``Breakout-v0``), with its run directory, logger,
  telemetry export, resume checkpoints, preemption guard and stall
  watchdog;
- ``--env-backend gym`` (the default) with ``--actor-mode threads`` (the
  default): SEED-style host actors stepping gymnasium envs (or the
  registered ``PixelRing-v0``, ``RecallGym-v0``, ``BreakoutGym-v0``), every
  policy forward a central batched call on the card;
- ``--actor-mode process``: the reference's monobeast topology, actor
  processes with their own CPU policy over the shared-memory ring
  (``ProcessActorLearnerTrainer``); the learner on the card.  They build
  their envs through ``make_host_envs`` (the port's own numpy envs for
  their ids, no gymnasium needed);
- ``--actor-mode serving``: the inference plane (``scalerl_torch/serving/``):
  actor threads act through ``RemotePolicyClient``s against one
  ``InferenceServer`` holding the policy on the card, with dynamic batching
  (``--serve-max-batch``, ``--serve-max-wait-ms``), bounded admission
  (``--serve-max-pending``) and generation-tagged parameters; the serving
  SLO (latency p50/p95/p99, requests, batch occupancy) is printed at the
  end.

Every field of ``scalerl_torch.config.ImpalaArguments`` is an option under
the JAX package's spelling (``--max-timesteps``, ``--env-id``,
``--resume <run dir>``, ``--logger-backend none``).  It runs on the card and
raises without one; ``--device cpu`` runs on the host.  Host smoke run::

    python examples/train_impala_torch.py --device cpu --env-backend jax \
        --env-id CartPole-v1 --max-timesteps 20000 --use-lstm false
    python examples/train_impala_torch.py --device cpu --actor-mode process \
        --env-id CartPole-v1 --num-actors 2 --num-envs 4 --num-buffers 8 \
        --max-timesteps 20000 --use-lstm false
    python examples/train_impala_torch.py --device cpu --actor-mode serving \
        --env-id CartPole-v1 --num-actors 2 --num-envs 4 --num-buffers 8 \
        --max-timesteps 20000 --use-lstm false
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import ImpalaArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(ImpalaArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.impala import ImpalaAgent

    if args.env_backend == "jax":
        from scalerl_torch.envs.tensor_envs import make_tensor_vec_env
        from scalerl_torch.trainer.actor_learner import DeviceActorLearnerTrainer

        venv = make_tensor_vec_env(args.env_id, num_envs=args.num_envs, device=device)
        agent = ImpalaAgent(args, venv.observation_shape, venv.num_actions, device=device)
        trainer = DeviceActorLearnerTrainer(args, agent, venv)
    else:
        from scalerl_torch.envs.gym_env import make_host_envs, make_vect_envs
        from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

        envs_per_actor = max(args.num_envs // args.num_actors, 1)
        atari = args.env_id.startswith("ALE/") or "NoFrameskip" in args.env_id
        env_fns = [
            (lambda i=i: make_vect_envs(args.env_id, num_envs=envs_per_actor,
                                        seed=args.seed + i, async_envs=envs_per_actor > 1,
                                        atari=atari))
            for i in range(args.num_actors)
        ]
        probe = make_host_envs(args.env_id, 1, args.seed, **({"atari": True} if atari else {}))
        obs_shape = probe.single_observation_space.shape
        num_actions = probe.single_action_space.n
        probe.close()
        agent = ImpalaAgent(args, obs_shape, num_actions, device=device)
        if args.actor_mode == "process":
            from scalerl_torch.trainer.process_actor_learner import ProcessActorLearnerTrainer

            trainer = ProcessActorLearnerTrainer(args, agent)
        else:
            trainer = HostActorLearnerTrainer(args, agent, env_fns)

    print("device:", agent.device)
    try:
        result = trainer.train(total_frames=args.total_steps)
        print("final:", {k: round(float(v), 3) for k, v in result.items()})
        if getattr(trainer, "inference_server", None) is not None:
            slo = trainer.inference_server.slo()
            print("serving SLO:", {k: round(float(v), 3) for k, v in slo.items()})
        if args.save_model and not args.disable_checkpoint:
            path = agent.save_checkpoint(os.path.join(trainer.model_save_dir, "ckpt_final"))
            print("checkpoint:", path)
    finally:
        trainer.close()
    return {"trainer": trainer, "agent": agent, "result": result}


if __name__ == "__main__":
    main()
