"""``python -m rdst_tpu_torch.train --config-file X.ini [--gpu-id N]
[--seed S] [KEY=VALUE ...]``: the port's counterpart of ``train.py``."""

from rdst_tpu_torch.cli import train_main

if __name__ == "__main__":
    train_main()
