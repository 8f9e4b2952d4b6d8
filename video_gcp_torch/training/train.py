"""CLI entry: python -m video_gcp_torch.training.train --path <conf_dir>
[--device cpu] (see training/trainer.py for the flags)."""
from video_gcp_torch.training.trainer import main

if __name__ == "__main__":
    main()
