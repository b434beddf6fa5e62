"""The port's flash attention (``fedml_tpu_torch/ops/flash_attention.py``)
held against the JAX package's on the same numpy inputs.

On the CPU the port's forward is its plain version (dense fp32), so this
pins the function the CUDA kernel is held to on the card; the JAX side is
the Pallas kernel in interpret mode and ``dense_attention``.  The backward
is the port's blockwise fp32 backward either way.  Tolerances are the JAX
package's own (``tests/test_flash_attention.py``): forward 2e-5, gradients
rtol 2e-4 / atol 2e-5; bf16 5e-2 (``tests/test_conv_mxu.py``'s bf16
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import flash_attention as jflash
from fedml_tpu.parallel.ring_attention import dense_attention
from fedml_tpu_torch.ops.flash_attention import (
    _flash_plan,
    _kv_tiles,
    _q_tile_order,
    _schedule_table,
    _wg_schedule,
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    flash_attention_with_lse,
    flash_attn_fn,
    pick_block,
)

FWD = {"rtol": 2e-5, "atol": 2e-5}


def _qkv(L=64, H=2, D=16, seed=0, B=None):
    rng = np.random.RandomState(seed)
    shape = (L, H, D) if B is None else (B, L, H, D)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,H,D,bq,bk", [(64, 2, 16, 16, 16), (96, 1, 8, 32, 16)],
                         ids=["one_block_pair", "multi_block_carry"])
def test_forward_matches_jax_kernel_and_dense(causal, L, H, D, bq, bk):
    q, k, v = _qkv(L, H, D, seed=L)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True))
    dense = np.asarray(dense_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal))
    got = flash_attention(*_t(q, k, v), causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (L, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_allclose(got.numpy(), dense, **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax(causal):
    q, k, v = _qkv(64, 2, 16, seed=5)
    jo, jl = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 32, 16, True)
    o, lse = flash_attention_with_lse(*_t(q, k, v), causal, 32, 16)
    assert lse.shape == (2, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)


def test_batched_form_is_the_vmapped_jax_function():
    q, k, v = _qkv(32, 2, 8, seed=6, B=3)
    run = lambda a, b, c: jflash.flash_attention_with_lse(  # noqa: E731
        a, b, c, True, 16, 16, True)
    jo, jl = jax.vmap(run)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = flash_attention_with_lse(*_t(q, k, v), True, 16, 16)
    assert o.shape == (3, 32, 2, 8) and lse.shape == (3, 2, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)
    o2, lse2 = flash_attention_fwd(*_t(q, k, v), causal=True)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)


def test_rejects_ragged_as_jax_does():
    q, k, v = _qkv(L=60)
    with pytest.raises(ValueError):
        jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=16, block_k=16, interpret=True)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*_t(q, k, v), block_q=16, block_k=16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_lse", [False, True], ids=["o_only", "o_and_lse"])
def test_gradients_match_jax(causal, use_lse):
    """dq/dk/dv of the port's backward against ``jax.grad`` through the
    JAX package's custom VJP, including the LSE cotangent."""
    L, H, D = 32, 2, 8
    q, k, v = _qkv(L, H, D, seed=3)
    rng = np.random.RandomState(4)
    cot = rng.randn(L, H, D).astype(np.float32)
    w = rng.randn(H, L).astype(np.float32) if use_lse else np.zeros((H, L), np.float32)

    def jloss(a, b, c):
        o, lse = jflash.flash_attention_with_lse(a, b, c, causal, 8, 8, True)
        return (o * cot).sum() + (lse * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal, 8, 8)
    loss = (o * torch.from_numpy(cot)).sum()
    if use_lse:
        loss = loss + (lse * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, r, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_autograd_through_plain(causal):
    q, k, v = _qkv(48, 2, 8, seed=7, B=2)
    cot = torch.from_numpy(np.random.RandomState(8).randn(2, 48, 2, 8).astype(np.float32))

    def grads(fn):
        leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * cot).sum() + lse.sum(), leaves)

    got = grads(lambda a, b, c: flash_attention_with_lse(a, b, c, causal, 16, 16))
    want = grads(lambda a, b, c: attention_plain(a, b, c, causal))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax_kernel(causal):
    q, k, v = _qkv(64, 2, 16, seed=9)
    want = jflash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        block_q=32, block_k=32, interpret=True)
    got = flash_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)),
                          causal=causal, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def test_attn_fn_and_pick_block_mirror_jax():
    q, k, v = _qkv(32, 2, 8, seed=10, B=2)
    attn = flash_attn_fn(block_q=16, block_k=16)
    want = flash_attention(*_t(q, k, v), causal=True, block_q=16, block_k=16)
    torch.testing.assert_close(attn(*_t(q, k, v), True), want, rtol=0, atol=0)
    for n in (80, 128, 1000, 1024, 1536, 4096, 8192, 3 * 128):
        assert pick_block(n) == jflash.pick_block(n)
        assert pick_block(n, 256) == jflash.pick_block(n, 256)


# ---------------------------------------------------------------- the plan
# ``_flash_plan`` decides the CUDA route by one static condition, and for
# the wgmma route the schedule the kernel runs; the C entry point launches
# the plan as given (refusing only kernels, tiles and blocks it was not
# built with), so these pin what the card launches.

H100_SMEM = 232_448  # dynamic shared memory one H100 block may use


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 16, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"), (torch.float32, 32, "fma"),
    (torch.float32, 16, "fma"), (torch.float32, 8, "fma")])
def test_plan_route_for_every_width_the_kernel_takes(dtype, d, route):
    plan = _flash_plan(dtype, d, 1024, 1024, True, batch=8, heads=10)
    assert plan.route == route
    assert plan.smem_bytes <= H100_SMEM
    if route == "wgmma":
        # 128 x 128 tiles; Q, the staged O and a 2-stage K and V ring of
        # 128-row boxes of 64 bf16, barriers, alignment slack; persistent:
        # one block per SM over the 8 x 10 x 8 q tiles
        assert (plan.bq, plan.bn, plan.stages, plan.threads) == (128, 128, 2, 384)
        assert plan.smem_bytes == 6 * (d // 64) * 128 * 128 + 128 + 1024
        assert plan.grid == (132, 1, 1)
        small = _flash_plan(dtype, d, 200, 200, True, batch=2, heads=3)
        assert small.grid == (12, 1, 1)  # fewer q tiles than SMs: one each
    else:
        assert (plan.bq, plan.bn) == (64, 64) and plan.grid == (16, 10, 8)


@pytest.mark.parametrize("d", [0, 4, 24, 48, 96, 256])
def test_plan_refuses_other_widths(d):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head width"):
            _flash_plan(dtype, d, 128, 128, False)


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        _flash_plan(torch.float16, 128, 128, 128, False)


@pytest.mark.parametrize("lq", [80, 200, 1000, 1088, 8192])
def test_plan_orders_q_tiles_heaviest_first_under_causal(lq):
    for d in (64, 128):
        plan = _flash_plan(torch.bfloat16, d, lq, lq, True, batch=2, heads=3)
        order = _q_tile_order(plan, lq)
        assert sorted(order) == list(range(-(-lq // 128)))
        work = [_kv_tiles(plan, qt, lq, lq, True) for qt in order]
        assert work == sorted(work, reverse=True) and work[0] == -(-lq // 128)
        # every block starts with a q tile no lighter than any run later
        blocks = _wg_schedule(plan, lq, lq, 2, 3, True)
        later = [w for blk in blocks for *_, w in blk[1:]]
        assert min(blk[0][3] for blk in blocks) >= max(later, default=0)
        # without the mask every tile has the same work
        flat = _flash_plan(torch.bfloat16, d, lq, lq, False, batch=2, heads=3)
        assert _q_tile_order(flat, lq) == list(range(-(-lq // 128)))
    # v2's routes launch one block per q tile in the hardware's order
    for dtype, d in ((torch.bfloat16, 32), (torch.float32, 128)):
        plan = _flash_plan(dtype, d, lq, lq, True, batch=2, heads=3)
        assert not plan.heavy_first and plan.grid == (-(-lq // 64), 3, 2)


@pytest.mark.parametrize("b,lq,h,causal", [(8, 1024, 10, True), (8, 1024, 20, True),
                                           (1, 8192, 10, True), (4, 2048, 10, True),
                                           (8, 1024, 10, False), (2, 200, 3, True),
                                           (64, 80, 4, True)])
def test_wgmma_schedule_deals_every_q_tile_once_and_evenly(b, lq, h, causal):
    """The persistent blocks cover each (q tile, head, batch) exactly once;
    each block starts heavy, and no block carries more than the mean work
    plus one q tile's (the bound of a greedy heaviest-first deal)."""
    plan = _flash_plan(torch.bfloat16, 128, lq, lq, causal, batch=b, heads=h)
    blocks = _wg_schedule(plan, lq, lq, b, h, causal)
    assert len(blocks) == plan.grid[0] and all(blocks)
    tiles = [t[:3] for blk in blocks for t in blk]
    n_qt = -(-lq // 128)
    assert sorted(tiles) == sorted((qt, hh, bb) for qt in range(n_qt)
                                   for hh in range(h) for bb in range(b))
    assert all(w == _kv_tiles(plan, qt, lq, lq, causal) for blk in blocks
               for qt, _, _, w in blk)
    work = [sum(w for *_, w in blk) for blk in blocks]
    assert max(work) <= sum(work) / len(work) + _kv_tiles(plan, n_qt - 1, lq, lq, causal)
    if causal:
        assert all(blk[0][0] >= blk[-1][0] for blk in blocks)


@pytest.mark.parametrize("b,lq,lk,h,causal", [(8, 1024, 1024, 10, True), (2, 200, 200, 3, True),
                                              (4, 512, 512, 20, False), (2, 160, 64, 2, True),
                                              (1, 64, 160, 2, True)])
def test_schedule_table_is_what_the_kernel_reads(b, lq, lk, h, causal):
    """The int32 table the entry point hands the kernel: entry ``[k, blk]``
    is block blk's k-th (q tile, head, batch, KV tiles), and a q tile of -1
    marks only the end of a block's list."""
    plan = _flash_plan(torch.bfloat16, 64, lq, lk, causal, batch=b, heads=h)
    blocks = _wg_schedule(plan, lq, lk, b, h, causal)
    table = _schedule_table(blocks)
    assert table.dtype == np.int32 and table.shape == (max(map(len, blocks)), plan.grid[0], 4)
    for blk, work in enumerate(blocks):
        assert [tuple(e) for e in table[:len(work), blk]] == list(work)
        assert (table[len(work):, blk, 0] == -1).all()
    assert (table[..., 0] >= -1).all() and (table[..., 0] < -(-lq // 128)).all()


def _kv_tiles_from_mask(lq, lk, q0, bq, bn, causal):
    """KV tiles a q tile must read, counted from the dense mask: the tile of
    the last key that some valid row of [q0, q0 + bq) sees."""
    qpos = np.arange(q0, min(q0 + bq, lq))[:, None]
    kpos = np.arange(lk)[None, :]
    visible = (kpos <= qpos) if causal else np.ones((len(qpos), lk), bool)
    keys = np.nonzero(visible.any(0))[0]
    return 0 if keys.size == 0 else int(keys[-1]) // bn + 1


@pytest.mark.parametrize("lq,lk", [(80, 80), (200, 200), (1000, 1000), (1088, 1088),
                                   (64, 160), (160, 64), (200, 1000), (1000, 200),
                                   (1088, 80)])
@pytest.mark.parametrize("causal", [False, True])
def test_kv_tile_counts_match_the_mask(lq, lk, causal):
    """The wgmma schedule's KV-tile count of every q tile (the kernel
    reads exactly that many) against a brute-force count from the mask."""
    for d in (128, 64):
        plan = _flash_plan(torch.bfloat16, d, lq, lk, causal, batch=2, heads=2)
        seen = {(qt, hh, bb): w for blk in _wg_schedule(plan, lq, lk, 2, 2, causal)
                for qt, hh, bb, w in blk}
        for (qt, _, _), w in seen.items():
            assert w == _kv_tiles_from_mask(lq, lk, qt * plan.bq, plan.bq, plan.bn,
                                            causal), (d, qt)
