"""Train a reduced LM on the PyTorch port (the torch twin of
``examples/train_lm.py``): the production launcher's loop, with
checkpointing and the straggler watchdog, at a small size.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 60] [--device cpu]

The full-size configs are exercised by the dry run
(``python -m repro_torch.launch.dryrun``); this is the end-to-end training
loop at a size a CPU runs.  Checkpoints go to ``build/torch_lm_ckpt`` of
the checkout unless ``--ckpt-dir`` says otherwise, and a second run
resumes from the latest.
"""

import argparse
from pathlib import Path

from repro_torch.launch.train import main as train_main


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="60")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(__file__).resolve().parents[1] / "build" / "torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train_main(["--arch", "qwen3-14b", "--smoke", "--steps", args.steps,
                "--ckpt-dir", args.ckpt_dir, "--device", args.device])


if __name__ == "__main__":
    main()
