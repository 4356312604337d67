"""``python -m rdst_tpu_torch.test --config-file X.ini [--gpu-id N]
[KEY=VALUE ...]``: the port's counterpart of ``test.py``."""

from rdst_tpu_torch.cli import test_main

if __name__ == "__main__":
    test_main()
