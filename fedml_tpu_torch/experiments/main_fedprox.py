"""Entry shim: FedProx (reference parity with ``main_fedprox.py``).

    python -m fedml_tpu_torch.experiments.main_fedprox [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "fedprox", *sys.argv[1:]])
