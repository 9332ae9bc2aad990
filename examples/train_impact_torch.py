"""IMPACT on PyTorch: the twin of ``examples/train_impact.py``.

IMPACT (arxiv 1912.00167) on the host actor plane
(``HostActorLearnerTrainer``, SEED-style actor threads with central batched
inference on the card): a clipped target-network surrogate, and a circular
buffer that replays each trajectory chunk ``--replay-times`` times, one
V-trace launch an update under ``--use-pallas``.  Actors build their envs
through ``make_host_envs``: gymnasium ids, the port's own numpy envs
(``PixelRing-v0``, ``RecallGym-v0``, ``BreakoutGym-v0``) without gymnasium,
or with ``--env-backend jax`` the port's tensor env of the id stepped on the
CPU.  Every field of ``scalerl_torch.config.ImpactArguments`` is an option
under the JAX package's spelling (``--replay-times``,
``--target-update-frequency``, ``--resume <run dir>``).  It runs on the
card and raises without one; ``--device cpu`` runs on the host::

    python examples/train_impact_torch.py --device cpu --env-backend jax \
        --env-id CartPole-v1 --num-actors 2 --num-envs 8 --batch-size 8 \
        --rollout-length 16 --use-lstm false --max-timesteps 20000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import ImpactArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(ImpactArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.impact import ImpactAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    envs_per_actor = max(args.num_envs // args.num_actors, 1)
    atari = args.env_id.startswith("ALE/") or "NoFrameskip" in args.env_id
    env_kw = {"atari": True} if atari else {}
    env_fns = [
        (lambda i=i: make_host_envs(args.env_id, envs_per_actor, args.seed + i,
                                    args.env_backend, **env_kw))
        for i in range(args.num_actors)
    ]
    probe = make_host_envs(args.env_id, 1, args.seed, args.env_backend, **env_kw)
    obs_shape = probe.single_observation_space.shape
    num_actions = probe.single_action_space.n
    probe.close()
    agent = ImpactAgent(args, obs_shape, num_actions, device=device)
    trainer = HostActorLearnerTrainer(args, agent, env_fns)
    print("device:", agent.device)
    try:
        result = trainer.train(total_frames=args.total_steps)
        print("final:", {k: round(float(v), 3) for k, v in result.items()})
        print("surrogate buffer:", agent.surrogate.stats())
        if args.save_model and not args.disable_checkpoint:
            path = agent.save_checkpoint(os.path.join(trainer.model_save_dir, "ckpt_final"))
            print("checkpoint:", path)
    finally:
        trainer.close()
    return {"trainer": trainer, "agent": agent, "result": result}


if __name__ == "__main__":
    main()
