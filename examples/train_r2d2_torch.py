"""R2D2 on PyTorch: the twin of ``examples/train_r2d2.py``.

Two backends:

- ``--env-backend gym`` (the default): the host actor plane
  (``scalerl_torch/trainer/r2d2.py``): actor threads fill ``[T+1, B]``
  sequence slots with their entering LSTM state, every forward a central
  call on the card; the learner keeps a prioritised sequence replay on the
  card and runs burn-in and n-step double-Q updates under value rescaling.
  Envs are gymnasium's, or the port's numpy envs for their ids
  (``RecallGym-v0``, ``PixelRing-v0``, ``BreakoutGym-v0``); each of the
  ``--num-actors`` actors gets ``--num-envs / --num-actors`` of them.
- ``--env-backend jax``: ``DeviceR2D2Trainer`` over the port's tensor env
  of that id (``Recall-v0``, ``SyntheticPixel-v0``, ...) on the card:
  collection, replay and learning without a host round trip.

Every field of ``scalerl_torch.config.R2D2Arguments`` is an option under the
JAX package's spelling; ``--use-pallas`` samples the replay with the CUDA
kernels.  It runs on the card and raises without one; ``--device cpu`` runs
on the host::

    python examples/train_r2d2_torch.py --device cpu --env-id RecallGym-v0 \
        --max-timesteps 20000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import R2D2Arguments, parse_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parse_args(R2D2Arguments, argv, parser)
    device = parser.parse_known_args(argv)[0].device

    from scalerl_torch.agents.r2d2 import R2D2Agent

    if args.env_backend == "jax":
        from scalerl_torch.envs.tensor_envs import make_tensor_vec_env
        from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

        venv = make_tensor_vec_env(args.env_id, args.num_envs, device=device)
        agent = R2D2Agent(args, venv.observation_shape, venv.num_actions, device=device)
        trainer = DeviceR2D2Trainer(args, agent, venv)
    else:
        from scalerl_torch.envs.gym_env import make_host_envs
        from scalerl_torch.trainer.r2d2 import R2D2Trainer

        envs_per_actor = max(args.num_envs // args.num_actors, 1)
        env_fns = [(lambda i=i: make_host_envs(args.env_id, envs_per_actor, args.seed + i))
                   for i in range(args.num_actors)]
        probe = make_host_envs(args.env_id, 1, args.seed)
        obs_shape, num_actions = probe.single_observation_space.shape, probe.single_action_space.n
        probe.close()
        agent = R2D2Agent(args, obs_shape, num_actions, device=device)
        trainer = R2D2Trainer(args, agent, env_fns)
    print("device:", agent.device)
    try:
        result = trainer.train(total_frames=args.max_timesteps)
        print("final:", {k: round(float(v), 3) for k, v in result.items()})
    finally:
        trainer.close()
    return {"trainer": trainer, "agent": agent, "result": result}


if __name__ == "__main__":
    main()
