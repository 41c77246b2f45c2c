"""Readings for a latent-attention cell's limits, on the card:
``calibrate.py`` with the latent driver's program and reference
(``drivers/train_latent.py``) in place of the training driver's, and
``faults_latent.py``'s faults in place of ``faults.py``'s.

    python3 perfbench/calibrate_latent.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out file.json]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    from unittest import mock

    from perfbench import calibrate, faults, faults_latent, harness
    from perfbench.drivers import train_latent

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    args, _ = ap.parse_known_args(argv)
    cell = harness.resolve(args.workload)
    with train_latent.latent_cell(cell.config), \
            mock.patch.dict(faults.FAULTS, faults_latent.FAULTS):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
