"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu`` for one NVIDIA H100.

Each module sits at the same path as its counterpart in ``fedml_tpu``
(``core/``, ``data/``, ``models/``, ``ops/``, ``algorithms/``, ``utils/``,
``obs/``), so the JAX reference of any piece is found by path.  The
layers, from the entry point down:

    algorithms/fedavg.py    FedAvgSimulation, make_round_fn, make_multi_round_fn
    core/client.py          client optimizer, local update, evaluator
    models/resnet*.py       CifarResNet (library convs), CifarResNetTPU (kernel convs)
    ops/conv_mxu.py         implicit-GEMM 3x3 conv: hand-written sm_90a CUDA
                            kernel (ops/csrc/conv_mxu.cu) + its plain version
    core/types.py, data/    host packing of federated data onto the device

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``fedml_tpu``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""
