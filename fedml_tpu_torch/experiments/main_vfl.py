"""Entry shim: vertical FL (reference parity with ``main_vfl.py``).

    python -m fedml_tpu_torch.experiments.main_vfl [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "vfl", *sys.argv[1:]])
