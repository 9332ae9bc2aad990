"""Parallel DQN on PyTorch: the twin of ``examples/train_parallel_dqn.py``.

Actor processes act by numpy inference on versioned weight snapshots and
hand transitions to the learner through the lock-free shared-memory ring
(``scalerl_torch/csrc/shm_ring.cpp``, built with g++ at first use); the
learner trains double DQN on the card, with ``--use-per --use-pallas`` on
the PER kernels.  Every field of ``scalerl_torch.config.DQNArguments`` is
an option under the JAX package's spelling (``--max-timesteps``,
``--num-actors``, ``--rollout-length``, ``--use-per``).  The actors reach
their env through ``make_host_envs``: ``--env-backend gym`` (the default)
steps gymnasium envs (or the port's own numpy envs for their ids),
``--env-backend jax`` the port's tensor env of that id on the CPU.  It
runs on the card and raises without one; ``--device cpu`` runs the learner
on the host::

    python examples/train_parallel_dqn_torch.py --device cpu --env-backend jax \\
        --env-id CartPole-v1 --max-timesteps 20000 --num-actors 4
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import DQNArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(DQNArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.parallel_dqn import ParallelDQNTrainer

    probe = make_host_envs(args.env_id, 1, args.seed, args.env_backend)
    obs_shape = probe.single_observation_space.shape
    action_dim = probe.single_action_space.n
    probe.close()
    agent = DQNAgent(args, obs_shape, action_dim, device=device)
    trainer = ParallelDQNTrainer(args, agent, env_id=args.env_id, obs_shape=obs_shape,
                                 num_actors=args.num_actors)
    print("device:", agent.device)
    try:
        result = trainer.train()
        print("final:", {k: round(float(v), 3) for k, v in result.items()})
    finally:
        trainer.close()
    return {"trainer": trainer, "agent": agent, "result": result}


if __name__ == "__main__":
    main()
