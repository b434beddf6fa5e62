"""Entry shim: TurboAggregate secure aggregation (reference parity with ``main_turboaggregate.py``).

    python -m fedml_tpu_torch.experiments.main_turboaggregate [--comm_round N ...]
"""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "turboaggregate", *sys.argv[1:]])
