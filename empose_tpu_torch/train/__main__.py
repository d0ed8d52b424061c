"""``python -m empose_tpu_torch.train``: see ``empose_tpu_torch/train/cli.py``."""

from empose_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
