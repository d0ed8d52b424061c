"""``python -m empose_tpu_torch.eval``: see ``empose_tpu_torch/eval/cli.py``."""

from empose_tpu_torch.eval.cli import main

if __name__ == "__main__":
    main()
