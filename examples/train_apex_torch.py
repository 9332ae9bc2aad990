"""Ape-X DQN on PyTorch: the twin of ``examples/train_apex.py``.

N prioritised actor threads and one PER learner on the card
(``scalerl_torch/trainer/apex.py``); ``--use-pallas`` routes the replay's
sample and priority update through the CUDA kernels.  Every field of
``scalerl_torch.config.ApexArguments`` is an option under the JAX package's
spelling; ``--env-backend`` as in ``examples/train_dqn_torch.py`` (each
actor gets ``--num-envs`` envs).  It runs on the card and raises without
one; ``--device cpu`` runs on the host::

    python examples/train_apex_torch.py --device cpu --env-backend jax \
        --num-actors 2 --max-timesteps 20000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import ApexArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(ApexArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.apex import ApexTrainer

    def make_envs(actor_id: int):
        return make_host_envs(args.env_id, args.num_envs, args.seed + 1000 * actor_id,
                              args.env_backend)

    eval_envs = make_host_envs(args.env_id, 2, args.seed + 1, args.env_backend)
    probe = make_envs(0)
    agent = DQNAgent(args, probe.single_observation_space.shape, probe.single_action_space.n,
                     device=device)
    probe.close()
    trainer = ApexTrainer(args, agent, make_envs, eval_envs)
    print("device:", agent.device)
    try:
        result = trainer.run()
        print("final:", result)
        final_eval = trainer.run_evaluate_episodes()
        print("eval:", final_eval)
    finally:
        trainer.close()
        eval_envs.close()
    return {"trainer": trainer, "agent": agent, "result": result, "eval": final_eval}


if __name__ == "__main__":
    main()
