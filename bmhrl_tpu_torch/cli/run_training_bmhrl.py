"""BMHRL-tuned training CLI of the port (the port of
cli/run_training_bmhrl.py): ``cli.run_training`` with the BMHRL defaults
applied first (mode BMHRL, 10 warmstart epochs, B=32, worker and manager
gammas 0.8); flags given on the command line win.
"""
from __future__ import annotations

import sys

from bmhrl_tpu_torch.cli.run_training import main as base_main

BMHRL_DEFAULTS = [
    "--mode", "BMHRL",
    "--rl_warmstart_epochs", "10",
    "--B", "32",
    "--rl_gamma_worker", "0.8",
    "--rl_gamma_manager", "0.8",
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # user-provided flags win over the tuned defaults
    given = {a for a in argv if a.startswith("--")}
    merged = []
    i = 0
    while i < len(BMHRL_DEFAULTS):
        flag, val = BMHRL_DEFAULTS[i], BMHRL_DEFAULTS[i + 1]
        if flag not in given:
            merged += [flag, val]
        i += 2
    return base_main(merged + argv)


if __name__ == "__main__":
    main()
