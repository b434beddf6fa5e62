"""FedOpt: FedAvg with a server-side optimizer (port of
``fedml_tpu/algorithms/fedopt.py``).

The round's aggregate becomes the pseudo-gradient ``Δ = w_global −
w_avg`` (the reference's sign convention, ``FedOptAggregator.py:110-118``)
and a server optimizer from ``core/optrepo.py`` steps on it, over
``params`` only: ``batch_stats`` take the plain weighted average, as the
reference's buffers come from the averaged state dict.  The optimizer
state is ``ServerState.opt_state``, a tree of tensors that checkpoints
with the rest of the round state.
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    FedAvgSimulation,
    ServerUpdateFn,
)
from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.core.losses import LossFn, masked_softmax_ce
from fedml_tpu_torch.core.optrepo import (
    GradientTransformation,
    apply_updates,
    get_server_optimizer,
)
from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.models.base import ModelBundle


def make_fedopt_server_update(server_opt: GradientTransformation) -> ServerUpdateFn:
    def server_update(old, agg, opt_state):
        pseudo_grad = treelib.tree_sub(old["params"], agg["params"])
        updates, new_opt_state = server_opt.update(pseudo_grad, opt_state,
                                                   old["params"])
        new_params = apply_updates(old["params"], updates)
        return {**agg, "params": new_params}, new_opt_state

    return server_update


class FedOptSimulation(FedAvgSimulation):
    """FedAvg driver + server optimizer (``--server_optimizer/--server_lr``,
    reference ``main_fedopt.py:54-60``)."""

    def __init__(
        self,
        bundle: ModelBundle,
        dataset: FedDataset,
        config: FedAvgConfig,
        *,
        server_optimizer: str = "adam",
        server_lr: float = 1e-2,
        server_momentum: float = 0.9,
        loss_fn: LossFn = masked_softmax_ce,
        **kwargs,
    ):
        server_opt = get_server_optimizer(
            server_optimizer, lr=server_lr, momentum=server_momentum)
        super().__init__(
            bundle, dataset, config, loss_fn=loss_fn,
            server_update=make_fedopt_server_update(server_opt),
            server_opt_init=lambda variables: server_opt.init(variables["params"]),
            **kwargs,
        )
