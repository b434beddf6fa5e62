"""Entry shim: FedAvg (reference parity with ``main_fedavg.py``).

    python -m fedml_tpu_torch.experiments.main_fedavg [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "fedavg", *sys.argv[1:]])
