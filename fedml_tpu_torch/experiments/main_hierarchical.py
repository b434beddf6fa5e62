"""Entry shim: hierarchical FedAvg (reference parity with ``main_hierarchical.py``).

    python -m fedml_tpu_torch.experiments.main_hierarchical [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "hierarchical", *sys.argv[1:]])
