"""Entry shim: decentralized gossip (reference parity with ``main_decentralized.py``).

    python -m fedml_tpu_torch.experiments.main_decentralized [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "decentralized", *sys.argv[1:]])
