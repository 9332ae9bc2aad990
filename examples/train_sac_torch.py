"""SAC on PyTorch: the twin of ``examples/train_sac.py``.

Vector envs with a continuous (``Box``) action space -> ``SACAgent`` ->
``OffPolicyTrainer.run()`` (device replay, optional PER through the CUDA
kernels under ``--use-pallas``), then a greedy evaluation.  Every field of
``scalerl_torch.config.SACArguments`` is an option under the JAX
package's spelling (``--max-timesteps``, ``--use-per``, ``--resume <run
dir>``).  Gymnasium's ``Pendulum-v1`` (the default id) needs gymnasium.
It runs on the card and raises without one; ``--device cpu`` runs on the
host::

    python examples/train_sac_torch.py --device cpu --env-id Pendulum-v1 \
        --max-timesteps 30000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import SACArguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(SACArguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    train_envs = make_host_envs(args.env_id, args.num_envs, args.seed, args.env_backend)
    eval_envs = make_host_envs(args.env_id, 2, args.seed + 1, args.env_backend)
    space = train_envs.single_action_space
    if not hasattr(space, "low"):
        raise SystemExit(
            f"SAC needs a continuous (Box) action space; {args.env_id} has "
            f"{type(space).__name__} actions"
        )
    agent = SACAgent(args, train_envs.single_observation_space.shape, space.low, space.high,
                     device=device)
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
