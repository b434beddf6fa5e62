"""Entry shim: FedOpt (reference parity with ``main_fedopt.py``).

    python -m fedml_tpu_torch.experiments.main_fedopt [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "fedopt", *sys.argv[1:]])
