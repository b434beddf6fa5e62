"""Entry shim: federated transformer fine-tuning (``fedllm``) on the
shakespeare sequences.

    python -m fedml_tpu_torch.experiments.main_fedllm [--comm_round N ...]
"""

import sys

if __package__ in (None, ""):  # run as a script: _bootstrap fixes sys.path
    import _bootstrap  # noqa: F401

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main([
        "--algorithm", "fedllm", "--dataset", "fed_shakespeare",
        *sys.argv[1:],
    ])
