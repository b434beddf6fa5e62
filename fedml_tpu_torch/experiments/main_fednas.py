"""Entry shim: FedNAS (reference parity with ``main_fednas.py``).

    python -m fedml_tpu_torch.experiments.main_fednas [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "fednas", *sys.argv[1:]])
