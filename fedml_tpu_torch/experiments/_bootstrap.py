"""Script-mode path shim for the ``main_*.py`` entry points.

Imported (as a plain top-level module: the script's own directory is on
``sys.path`` in script mode) only when a shim runs as
``python fedml_tpu_torch/experiments/main_fedavg.py``; puts the repo root
on ``sys.path`` so ``import fedml_tpu_torch`` resolves.  Running via
``python -m fedml_tpu_torch.experiments.main_fedavg`` never imports this.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
