"""The plain reference agrees with the program at tiny sizes on the CPU,
in float32: its copy of JAX's draws, the augmentation, each model's
forward and first gradients, and whole FedAvg rounds."""

import numpy as np
import pytest
import torch

from benchmark import correct, families, generator, program, weights
from benchmark.reference import fedavg, rng
from benchmark.tests.conftest import TOY_SEED, toy_cell


def test_draws_equal_the_programs():
    from fedml_tpu_torch.core import rng as prog

    key = rng.fold_in(rng.prng_key(TOY_SEED), 7)
    assert (key == prog.fold_in(prog.PRNGKey(TOY_SEED), 7)).all()
    assert (rng.split(key, 3) == prog.split(key, 3)).all()
    assert torch.equal(rng.permutation(key, 5000, "cpu"), prog.permutation(key, 5000, "cpu"))
    assert torch.equal(rng.randint(key, (64, 2), 0, 9, "cpu"), prog.randint(key, (64, 2), 0, 9, "cpu"))
    assert torch.equal(rng.bernoulli(key, 0.5, (64, 1, 1, 1), "cpu"),
                       prog.bernoulli(key, 0.5, (64, 1, 1, 1), "cpu"))


def test_augmentation_equals_the_programs():
    from fedml_tpu_torch.data.augment import make_image_augment

    key = rng.fold_in(rng.prng_key(3), 1)
    x = torch.randn(32, 32, 32, 3)
    assert torch.equal(make_image_augment(4, True, 16)(key, x),
                       fedavg.image_augment(key, x, 4, True, 16))


def test_pack_equals_the_programs():
    from fedml_tpu_torch.core.types import FedDataset, pack_clients

    cell = toy_cell("resnet56.silo10.b1024")
    data = generator.generate(cell.cfg, cell.traffic, 5, torch.device("cpu"))
    ds = FedDataset(data.train_x, data.train_y, None, None, data.train_client_idx, None, 10)
    steps = generator.packed_steps(data, 16)
    pack = pack_clients(ds, [0, 1, 2], 16, steps_per_epoch=steps, seed=TOY_SEED)
    for c in range(3):
        rows, mask, n = fedavg.pack_indices(data.train_client_idx[c], c, steps * 16, TOY_SEED)
        assert np.array_equal(pack.x[c].reshape(-1, 32, 32, 3), data.train_x[rows])
        assert np.array_equal(pack.mask[c].reshape(-1), mask) and pack.num_samples[c] == n


def _rel(a, b):
    diff = torch.cat([(a[k].double() - b[k].double()).flatten() for k in b])
    return float(diff.norm() / torch.cat([b[k].double().flatten() for k in b]).norm())


@pytest.mark.parametrize("name", ["resnet56.silo10.b1024", "gpt2l.silo4.l1024"])
def test_forward_and_gradients(name):
    """One batch's loss and gradients: the program's lie as close to the
    reference's in float64 as the reference's own float32 ones do."""
    from fedml_tpu_torch.core.losses import masked_softmax_ce

    cell = toy_cell(name)
    dev = torch.device("cpu")
    fam = families.load(cell.cfg["family"])
    data = generator.generate(cell.cfg, cell.traffic, 11, dev)
    w = weights.make_variables(fam.variable_shapes(cell.cfg), fam.init_rule, 11, dev)
    bundle = fam.program_bundle(cell.cfg, cell.traffic, dev)
    x = torch.from_numpy(data.train_x[:4])
    y = torch.from_numpy(data.train_y[:4])
    m = torch.ones(4)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w["params"].items()}
    logits, _ = bundle.apply_train({**w, "params": leaves}, x)
    loss, _ = masked_softmax_ce(logits, y, m)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref = fam.reference_model(cell.cfg, cell.traffic)
    out = {}
    for dt in (torch.float32, torch.float64):
        wd = {g: {k: t.to(dt) for k, t in leaves_.items()} for g, leaves_ in w.items()}
        xd = x.to(dt) if x.is_floating_point() else x
        out[dt] = ref.loss_and_grads(wd["params"], wd.get("batch_stats", {}), xd, y, m.to(dt))
    ls64, count64, g64, _ = out[torch.float64]
    assert float(loss.detach()) == pytest.approx(float(ls64 / count64), rel=1e-5)
    assert _rel(grads, g64) <= 3 * _rel(out[torch.float32][2], g64) + 1e-6


@pytest.mark.parametrize("name", ["resnet56.silo10.b1024", "gpt2l.silo4.l1024"])
def test_rounds_follow_the_program(name):
    """Two whole rounds: the program lies as close to the reference computed
    in float64 as the float32 reference does.  (A BatchNorm ResNet-56 at
    initialisation is chaotic enough that float32 and float64 part by
    several per cent within two rounds, so a fixed tolerance would say
    nothing.)"""
    cell = toy_cell(name)
    dev = torch.device("cpu")
    fam = families.load(cell.cfg["family"])
    data = generator.generate(cell.cfg, cell.traffic, TOY_SEED, dev)
    w0 = weights.make_variables(fam.variable_shapes(cell.cfg), fam.init_rule, TOY_SEED, dev)
    sim = program.build_simulation(fam, cell.cfg, cell.traffic, data, w0, TOY_SEED, dev)
    prog = correct.program_readings(sim, w0, 2)
    args = (fam, cell.cfg, cell.traffic, data, TOY_SEED, dev, 2)
    r32 = correct.reference_readings(*args)
    r64 = correct.reference_readings(*args, dtype=torch.float64)
    program_gap, float32_gap = correct.compare(prog, r64), correct.compare(r32, r64)
    for k, v in program_gap.items():
        assert v <= 3 * float32_gap[k] + 1e-6, (k, program_gap, float32_gap)
