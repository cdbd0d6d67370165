"""Training entry point: ``python -m rsis_tpu_torch.cli.train -model_name ...``

Counterpart of ``rsis_tpu/cli/train.py``: the same flags (those of the
port's ``Config``), one GPU. The run trains on the CUDA device unless the
caller of ``main`` passes another device; without a card it raises.
"""

from __future__ import annotations

from ..config import config_from_args
from ..train.loop import train


def main(argv=None, device=None):
    """Parse argv (default: the command line) and train; returns the final
    TrainState."""
    return train(config_from_args(argv), device=device)


if __name__ == "__main__":
    main()
