"""Deterministic fault injection — the chaos layer (port of
``fedml_tpu/faults``; the reference FedML's only failure path is
``MPI.COMM_WORLD.Abort()``).

- ``plan``  — seeded ``FaultPlan``/``FaultSpec``/``FaultRule`` schedules
  (stdlib-only; shipped to subprocesses via ``FEDML_TPU_CHAOS``);
- ``chaos`` — ``ChaosBackend``, the transport wrapper applying a plan on
  send/notify paths of inproc and tcp.

- ``traffic`` — seeded open-loop ``TrafficModel`` arrivals (offline
  rounds, stragglers, upload delays).

Process-level injection (SIGKILL at round r, hub restart, a crashed
muxer or edge hub) lives with the process orchestration of the TCP
transport, ``experiments/distributed_fedavg.py::launch``.
"""

from fedml_tpu_torch.faults.plan import (
    ACTIONS,
    ATTACK_ACTIONS,
    DEFAULT_FAULTABLE,
    ENV_VAR,
    FaultPlan,
    FaultRule,
    FaultSpec,
)
from fedml_tpu_torch.faults.chaos import ChaosBackend, attack_message, corrupt_message

__all__ = [
    "ACTIONS",
    "ATTACK_ACTIONS",
    "DEFAULT_FAULTABLE",
    "ENV_VAR",
    "ChaosBackend",
    "FaultPlan",
    "FaultRule",
    "FaultSpec",
    "attack_message",
    "corrupt_message",
]
