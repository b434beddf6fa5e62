"""Runtime lock-discipline checks (``locks.py``), the part of
``fedml_tpu/analysis`` that the comm runtime imports."""
