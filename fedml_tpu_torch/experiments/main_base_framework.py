"""Entry shim: the base-framework template (reference parity with
``fedml_experiments/distributed/base_framework``).

    python -m fedml_tpu_torch.experiments.main_base_framework [--client_num_in_total N ...]
"""

import sys

if __package__ in (None, ""):  # run as a script: _bootstrap fixes sys.path
    import _bootstrap  # noqa: F401

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(["--algorithm", "base_framework", *sys.argv[1:]])
