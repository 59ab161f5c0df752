"""``python -m distributed_ghs_implementation_tpu_torch``: see cli.py."""

import sys

from distributed_ghs_implementation_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
