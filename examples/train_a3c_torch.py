"""A3C on PyTorch: the twin of ``examples/train_a3c.py``.

``num_workers`` env lanes -> ``A3CAgent`` (central batched inference, one
synchronous clip-then-Adam update a chunk) -> ``OnPolicyTrainer.run()``,
then a greedy evaluation.  Every field of ``scalerl_torch.config.
A3CArguments`` is an option under the JAX package's spelling
(``--max-timesteps``, ``--rollout-length``, ``--resume <run dir>``).
``--env-backend gym`` (the default) steps gymnasium envs (or the port's own
numpy envs for their ids); ``--env-backend jax`` steps the port's tensor env
of that id on the CPU.  It runs on the card and raises without one;
``--device cpu`` runs on the host::

    python examples/train_a3c_torch.py --device cpu --env-backend jax \
        --env-id CartPole-v1 --max-timesteps 20000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import A3CArguments, parse_args


def run_on_policy(agent_cls, args, device: str) -> dict:
    """The on-policy entry points' body (A3C and PPO): envs, agent, trainer,
    run, final evaluation."""
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.on_policy import OnPolicyTrainer

    env_kw = {"normalize_obs": True} if args.normalize_obs else {}
    train_envs = make_host_envs(args.env_id, args.num_workers, args.seed, args.env_backend,
                                **env_kw)
    eval_envs = make_host_envs(args.env_id, 2, args.seed + 1, args.env_backend, **env_kw)
    agent = agent_cls(args, train_envs.single_observation_space.shape,
                      train_envs.single_action_space.n, device=device)
    trainer = OnPolicyTrainer(args, agent, train_envs, eval_envs)
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(A3CArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.a3c import A3CAgent

    return run_on_policy(A3CAgent, args, device)


if __name__ == "__main__":
    main()
