"""Entry shim: SplitNN (reference parity with ``main_splitnn.py``).

    python -m fedml_tpu_torch.experiments.main_splitnn [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "splitnn", *sys.argv[1:]])
