"""PPO on PyTorch: the twin of ``examples/train_ppo.py``.

The on-policy runtime A3C uses (``OnPolicyTrainer``: ``num_workers`` env
lanes, central batched inference) feeding ``PPOAgent``'s ``ppo_epochs x
num_minibatches`` clipped-surrogate steps a chunk, then a greedy
evaluation.  Every field of ``scalerl_torch.config.PPOArguments`` is an
option under the JAX package's spelling (``--num-minibatches``,
``--loss-reduction mean``, ``--resume <run dir>``).  ``--env-backend jax``
steps the port's tensor env of the id on the CPU.  It runs on the card and
raises without one; ``--device cpu`` runs on the host::

    python examples/train_ppo_torch.py --device cpu --env-backend jax \
        --env-id CartPole-v1 --max-timesteps 20000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # train_a3c_torch

from scalerl_torch.config import PPOArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(PPOArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.ppo import PPOAgent
    from train_a3c_torch import run_on_policy

    return run_on_policy(PPOAgent, args, device)


if __name__ == "__main__":
    main()
