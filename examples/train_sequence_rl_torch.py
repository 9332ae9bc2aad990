"""Sequence-RL training on PyTorch: token-PPO on the generation engines.

The PyTorch/CUDA twin of ``examples/train_sequence_rl.py``: the generation
engine decodes whole response batches, the recall/copy verifier scores them
on the host, and the token-PPO learner trains off the prioritized sequence
replay.  Runs on the GPU by default and raises without one; ``--device cpu``
runs the plain PyTorch versions of the kernels on the host.  Every field of
``scalerl_torch.config.GenRLArguments`` is an option (``--genrl-rounds``,
``--vocab-size``, ...).

Host smoke run::

    python examples/train_sequence_rl_torch.py --device cpu --genrl-rounds 100 \
        --vocab-size 8 --prompt-len 4 --max-new-tokens 4

Packed learner through the CUDA segment flash attention kernels, fed by the
continuous-batching engine over the paged KV cache::

    python examples/train_sequence_rl_torch.py --learner-packing true \
        --learner-packed-attn pallas --genrl-engine continuous --genrl-lanes 32

Speculative decoding on the continuous engine (n-gram self-drafting, one
verify pass a step; a boolean option alone means true)::

    python examples/train_sequence_rl_torch.py --genrl-engine continuous \
        --spec-enable --spec-k 4 --spec-ngram 3
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scalerl_torch.config import GenRLArguments


def _to_bool(text: str) -> bool:
    if text.lower() in ("1", "true", "yes", "on"):
        return True
    if text.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true or false, got {text!r}")


def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for f in dataclasses.fields(GenRLArguments):
        if isinstance(f.default, bool):
            parser.add_argument("--" + f.name.replace("_", "-"), dest=f.name, type=_to_bool,
                                nargs="?", const=True, default=f.default)
        else:
            parser.add_argument("--" + f.name.replace("_", "-"), dest=f.name,
                                type=type(f.default), default=f.default)
    ns = vars(parser.parse_args())
    device = ns.pop("device")
    return GenRLArguments(**ns), device


def main() -> None:
    args, device = parse_args()
    from scalerl_torch.trainer.sequence_rl import SequenceRLTrainer

    trainer = SequenceRLTrainer(args, device=device)
    print("device:", trainer.device)
    result = trainer.train(args.genrl_rounds)
    print("final:", {k: round(float(v), 4) for k, v in result.items()})
    if args.spec_enable:
        stats = trainer.engine.stats()
        print("speculation:", {k: stats[k] for k in ("spec_proposed", "spec_accepted",
                                                      "spec_acceptance_rate",
                                                      "spec_rollback_pages")})


if __name__ == "__main__":
    main()
