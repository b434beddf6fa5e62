"""Base-framework template: the tutorial algorithm new algorithms copy
(port of ``fedml_tpu/algorithms/base_framework.py``, its message form).

Reference ``fedml_api/distributed/base_framework/``: ``algorithm_api.py:
16-39`` forks process roles, ``central_worker.py:4-32`` collects one
scalar "local result" per client and sums them, ``central_manager.py:
8-53`` runs the INIT → collect → aggregate → broadcast round loop over
MPI.  The template comes in both forms:

- **message form** — ``BaseCentralManager`` / ``BaseClientManager`` run
  that choreography over any ``CommBackend`` (a FINISH message instead of
  the MPI ``Abort()`` shutdown); ``run_base_framework`` drives it on the
  in-process bus.
- **collective form** — ``make_compiled_round``: the same round as one
  ``psum`` over a clients mesh axis (``parallel/``), every rank computing
  its shard of the clients: what the message choreography becomes when
  every participant is a device of the mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from fedml_tpu_torch.comm.backend import CommBackend, NodeManager
from fedml_tpu_torch.comm.inproc import InprocBus
from fedml_tpu_torch.comm.message import (
    MSG_ARG_KEY_ROUND_INDEX,
    MSG_TYPE_S2C_FINISH,
    MSG_TYPE_S2C_INIT_CONFIG,
    Message,
)
from fedml_tpu_torch.parallel.compat import axis_index, axis_size, mesh_device, psum, use_mesh

SERVER = 0

# template-specific vocabulary (reference base_framework/message_define.py)
MSG_TYPE_S2C_INFORMATION = "S2C_INFORMATION"
MSG_TYPE_C2S_INFORMATION = "C2S_INFORMATION"
MSG_ARG_KEY_INFORMATION = "information"

# a client's contribution given (client_id, round_idx, global_result)
LocalComputeFn = Callable[[int, int, float], float]


def default_local_compute(client_id: int, round_idx: int,
                          global_result: float) -> float:
    """Deterministic stand-in "local training": decays the global value
    and adds a per-client offset, so rounds produce a checkable series."""
    return 0.5 * global_result / (client_id + 1) + (client_id + 1) * 0.01


class BaseCentralWorker:
    """Scalar aggregator (reference ``central_worker.py:4-32``): collect
    one local result per client, sum when all have arrived."""

    def __init__(self, client_num: int):
        self.client_num = client_num
        self.local_results: Dict[int, float] = {}

    def add_client_local_result(self, index: int, result: float) -> None:
        self.local_results[index] = result

    def check_whether_all_receive(self) -> bool:
        return len(self.local_results) == self.client_num

    def aggregate(self) -> float:
        total = float(sum(self.local_results.values()))
        self.local_results.clear()
        return total


class BaseClientWorker:
    """Per-client compute (reference ``client_worker.py``)."""

    def __init__(self, client_id: int,
                 local_compute: LocalComputeFn = default_local_compute):
        self.client_id = client_id
        self.local_compute = local_compute

    def compute(self, round_idx: int, global_result: float) -> float:
        return self.local_compute(self.client_id, round_idx, global_result)


class BaseCentralManager(NodeManager):
    """Round loop (reference ``central_manager.py:8-53``): INIT to all,
    collect C2S_INFORMATION, aggregate, broadcast or finish."""

    def __init__(self, backend: CommBackend, aggregator: BaseCentralWorker,
                 comm_rounds: int):
        self.aggregator = aggregator
        self.comm_rounds = comm_rounds
        self.round_idx = 0
        self.history: List[float] = []
        super().__init__(backend)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_INFORMATION, self._on_information
        )

    def start(self) -> None:
        for node in range(1, self.aggregator.client_num + 1):
            self.send_message(
                Message(MSG_TYPE_S2C_INIT_CONFIG, SERVER, node)
                .add_params(MSG_ARG_KEY_ROUND_INDEX, 0)
                .add_params(MSG_ARG_KEY_INFORMATION, 0.0)
            )

    def _on_information(self, msg: Message) -> None:
        self.aggregator.add_client_local_result(
            msg.sender - 1, msg.get(MSG_ARG_KEY_INFORMATION)
        )
        if not self.aggregator.check_whether_all_receive():
            return
        global_result = self.aggregator.aggregate()
        self.history.append(global_result)
        self.round_idx += 1
        if self.round_idx >= self.comm_rounds:
            for node in range(1, self.aggregator.client_num + 1):
                self.send_message(Message(MSG_TYPE_S2C_FINISH, SERVER, node))
            self.finish()
            return
        for node in range(1, self.aggregator.client_num + 1):
            self.send_message(
                Message(MSG_TYPE_S2C_INFORMATION, SERVER, node)
                .add_params(MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
                .add_params(MSG_ARG_KEY_INFORMATION, global_result)
            )


class BaseClientManager(NodeManager):
    """Client loop (reference ``client_manager.py``): on INIT or
    S2C_INFORMATION, compute the local result and send it up."""

    def __init__(self, backend: CommBackend, worker: BaseClientWorker):
        self.worker = worker
        super().__init__(backend)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self._on_round
        )
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INFORMATION, self._on_round
        )
        self.register_message_receive_handler(
            MSG_TYPE_S2C_FINISH, lambda msg: self.finish()
        )

    def _on_round(self, msg: Message) -> None:
        result = self.worker.compute(
            msg.get(MSG_ARG_KEY_ROUND_INDEX), msg.get(MSG_ARG_KEY_INFORMATION)
        )
        self.send_message(
            Message(MSG_TYPE_C2S_INFORMATION, self.backend.node_id, SERVER)
            .add_params(MSG_ARG_KEY_INFORMATION, result)
        )


def run_base_framework(
    num_workers: int,
    comm_rounds: int,
    local_compute: LocalComputeFn = default_local_compute,
) -> List[float]:
    """Drive the message-form template on the inproc bus; returns the
    per-round global results (reference's mpirun localhost demo,
    ``CI-script-framework.sh:16-23``)."""
    if comm_rounds < 1:
        raise ValueError(f"comm_rounds must be >= 1, got {comm_rounds}")
    bus = InprocBus()
    central = BaseCentralManager(
        bus.register(SERVER), BaseCentralWorker(num_workers), comm_rounds
    )
    managers = [
        BaseClientManager(bus.register(i + 1),
                          BaseClientWorker(i, local_compute))
        for i in range(num_workers)
    ]
    del managers
    central.start()
    bus.drain()
    return central.history


def make_compiled_round(mesh, local_compute=None, axis: str = "clients"):
    """The SAME template round as one collective: each rank computes its
    shard of the clients' local results and a ``psum`` over the mesh axis
    replaces collect + aggregate + broadcast.

    ``local_compute(client_ids, round_idx, global_result)`` maps this
    rank's float32 tensor of client ids to their local results; it
    defaults to ``default_local_compute``, whose arithmetic works on
    tensors as written.  Returns ``run(num_clients, comm_rounds)``, to be
    called on every rank of ``mesh``: the float32 history of the global
    result, the same on every rank."""
    if local_compute is None:
        local_compute = default_local_compute

    def run(num_clients: int, comm_rounds: int) -> np.ndarray:
        with use_mesh(mesh):
            n, me = axis_size(axis), axis_index(axis)
            if num_clients % n:
                raise ValueError(f"{num_clients} clients not divisible by the "
                                 f"{axis!r} axis of {n}")
            block = num_clients // n
            dev = mesh_device(mesh)
            cids = torch.arange(me * block, (me + 1) * block, dtype=torch.float32,
                                device=dev)
            g = torch.zeros((), dtype=torch.float32, device=dev)
            history = []
            for r in range(comm_rounds):
                g = psum(local_compute(cids, r, g).sum(), axis)
                history.append(g)
            return torch.stack(history).cpu().numpy()

    return run
