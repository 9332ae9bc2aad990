"""DQN on PyTorch: the twin of ``examples/train_dqn.py``.

Vector envs -> ``DQNAgent`` -> ``OffPolicyTrainer.run()``, then a greedy
evaluation.  Every field of ``scalerl_torch.config.DQNArguments`` is an
option under the JAX package's spelling (``--max-timesteps``,
``--categorical-dqn``, ``--noisy-dqn``, ``--use-per``, ``--resume <run
dir>``).  ``--env-backend gym`` (the default) steps gymnasium envs (or the
port's own numpy envs for their ids); ``--env-backend jax`` steps the port's
tensor env of that id on the CPU.  It runs on the card and raises without
one; ``--device cpu`` runs on the host::

    python examples/train_dqn_torch.py --device cpu --env-backend jax \
        --env-id CartPole-v1 --max-timesteps 20000
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
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    train_envs = make_host_envs(args.env_id, args.num_envs, args.seed, args.env_backend)
    eval_envs = make_host_envs(args.env_id, 2, args.seed + 1, args.env_backend)
    agent = DQNAgent(args, train_envs.single_observation_space.shape,
                     train_envs.single_action_space.n, device=device)
    trainer = OffPolicyTrainer(args, agent, train_envs, eval_envs)
    print("device:", agent.device)
    try:
        result = trainer.run()
        print("final:", result)
        final_eval = trainer.run_evaluate_episodes()
        print("eval:", final_eval)
    finally:
        trainer.close()
        train_envs.close()
        eval_envs.close()
    return {"trainer": trainer, "agent": agent, "result": result, "eval": final_eval}


if __name__ == "__main__":
    main()
