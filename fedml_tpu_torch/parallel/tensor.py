"""Tensor parallelism: a Megatron-style transformer over a ``tp`` mesh axis
(port of ``fedml_tpu/parallel/tensor.py``).

JAX annotates the parameter shardings and lets GSPMD insert the
collectives.  Here each mesh position is a rank holding its slices of the
parameters, and the collectives are written out in a counterpart of
``models/transformer.py::TransformerLM`` with the same state names:

- attention qkv projection kernel  [E, 3E]  → (None, tp)  column chunk
- attention output kernel          [E, E]   → (tp, None)  row chunk
- MLP up kernel / bias             [E, 4E] / [4E] → (None, tp) / (tp,)
- MLP down kernel                  [4E, E]  → (tp, None)  row chunk
- embeddings, LayerNorms, the MLP down bias → replicated

The column-parallel inputs pass through ``compat.replicated_in`` (identity
forward, psum backward: Megatron's copy-to-tp) and the row-parallel outputs
through ``compat.replicated_out`` (psum forward, identity backward: its
reduce-from-tp), the two conjugate operators of Megatron; the MLP down bias
is added after the sum.  (``compat.psum`` itself transposes
to a psum, which would multiply the gradient by the axis size here.)

The qkv kernel is stored as JAX lays it out, a contiguous column chunk
(with tp 2, rank 0 holds all of q and half of k), so shards and wire bytes
equal JAX's.  To compute, each rank gathers the kernel along its columns
(differentiable: ``psum_scatter`` backward) and takes its own heads' q, k
and v columns; when ``tp`` does not divide the heads, every rank computes
every head and keeps its row chunk of the output for the row-parallel
projection.  Attention runs the flash op on the rank's heads: on the card,
the hand-written kernel over strided views of the rank's own qkv output.

Initialise the full model once (the plain ``transformer_lm`` bundle, the
same values as JAX's for the same key) and lay it out with
``shard_tp_params``; the tensor-parallel module never draws its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core import tree as treelib
from fedml_tpu_torch.models.base import Dense, ModelBundle
from fedml_tpu_torch.models.transformer import (Block, LayerNorm, TransformerLM,
                                                _default_attn, transformer_lm)
from fedml_tpu_torch.parallel.compat import (_psum_leaves, all_gather, axis_index,
                                             current_mesh, mesh_device, replicated_in,
                                             replicated_out, use_mesh)
from fedml_tpu_torch.parallel import layout
from fedml_tpu_torch.parallel.layout import (axis_sizes, blocks, is_sharded, rewrap,
                                             shard_leaf)
from fedml_tpu_torch.parallel.spmd import make_1d_mesh
from fedml_tpu_torch.utils.device import DeviceLike

PyTree = Any


def make_tp_mesh(n_devices: Optional[int] = None, axis: str = "tp", *,
                 device: DeviceLike = None):
    return make_1d_mesh(n_devices, axis, device=device)


def _path_names(path) -> Tuple[str, ...]:
    """A leaf's flax path: ``(collection, state name)`` of the port's
    variables (``("params", "Block_0.Dense_1.kernel")``) as JAX's names
    (``("params", "Block_0", "Dense_1", "kernel")``)."""
    collection, name = path
    return (str(collection), *str(name).split("."))


def _tp_spec(names: Tuple[str, ...], axis: str) -> Tuple:
    in_attn = any("MultiHeadAttention" in n for n in names)
    in_block = any(n.startswith("Block_") for n in names)
    dense = next((n for n in names if n.startswith("Dense_")), None)
    if names[-1] == "kernel" and dense is not None and (in_attn or in_block):
        # qkv / MLP up (Dense_0) column-parallel, out / MLP down (Dense_1) row-parallel
        return (None, axis) if dense == "Dense_0" else (axis, None)
    if names[-1] == "bias" and dense == "Dense_0" and in_block and not in_attn:
        return (axis,)
    return ()


def tp_param_spec(variables: PyTree, axis: str = "tp") -> PyTree:
    """The spec tree of a ``TransformerLM`` variables tree (JAX's plan)."""
    return {c: {k: _tp_spec(_path_names((c, k)), axis) for k in sub}
            for c, sub in variables.items()}


def _device_put_message(name, shape, spec, d, entry, n) -> str:
    return (f"leaf {name!r} was given the spec {spec} over the {entry!r} axis of {n}, which "
            f"implies that the global size of its dimension {d} should be divisible by "
            f"{n}, but it is equal to {shape[d]} (full shape: {shape})")


def check_divisible(variables: PyTree, specs: PyTree, sizes: Dict[str, int]) -> None:
    """Refuse a layout whose axes do not divide a leaf, at the first such
    leaf in JAX's leaf order and with JAX's ``device_put`` message: nothing
    pads."""
    paths = sorted(((c, k) for c in variables for k in variables[c]), key=_path_names)
    layout.check_divisible([("/".join(_path_names((c, k))), variables[c][k].shape, specs[c][k])
                            for c, k in paths], sizes, _device_put_message)


def shard_tp_params(mesh, variables: PyTree, axis: str = "tp") -> PyTree:
    """This rank's ``Shard``s of the full variables under the TP plan."""
    specs = tp_param_spec(variables, axis)
    check_divisible(variables, specs, axis_sizes(mesh))
    return {c: {k: shard_leaf(mesh, v, specs[c][k]) for k, v in sub.items()}
            for c, sub in variables.items()}


def sharded_param_names(specs: PyTree):
    return [k for k, s in specs["params"].items() if is_sharded(s)]


# The largest spread between the ranks' own gradients of the replicated
# parameters that ``_MeanOverTP`` averaged, per mesh axis, since it was last
# cleared: max over leaves of max|g - mean| / max|mean|, a 0-dim tensor on
# the leaves' device (no sync to record).  Every rank computes those
# gradients from the same inputs, so it is 0 where the ranks agree; read it
# to see that they do.
REPLICA_SPREAD: Dict[str, torch.Tensor] = {}


class _MeanOverTP(torch.autograd.Function):
    """Identity forward; the cotangents averaged over the axis.  Every rank
    computes the replicated parameters' gradients itself: the mean keeps
    the replicas one should a kernel's sums differ between two ranks in
    their last bits, and is exact where the ranks agree ((g + g) / 2 = g).
    How far apart the ranks were goes to ``REPLICA_SPREAD``."""

    @staticmethod
    def forward(ctx, mesh, axis, *leaves):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.size(ctx.mesh.mesh_dim_names.index(ctx.axis))
        means = [g / n for g in _psum_leaves(ctx.mesh, list(grads), ctx.axis)]
        gaps = torch._foreach_norm(torch._foreach_sub(list(grads), means), float("inf"))
        scales = torch._foreach_norm(means, float("inf"))
        spread = (torch.stack([t.float() for t in gaps])
                  / torch.stack([t.float() for t in scales]).clamp_min(
                      torch.finfo(torch.float32).tiny)).max()
        prev = REPLICA_SPREAD.get(ctx.axis)
        REPLICA_SPREAD[ctx.axis] = spread if prev is None else torch.maximum(prev, spread)
        return (None, None, *means)


def mean_grads_over(params: dict, names, axis: str) -> dict:
    """``params`` with the leaves under ``names`` passed through
    ``_MeanOverTP`` over ``axis`` of the bound mesh (one all-reduce for
    all of them), where they take gradients and the axis has several
    ranks."""
    mesh = current_mesh()
    names = [k for k in names if params[k].requires_grad]
    if not names or not torch.is_grad_enabled() or mesh.size(
            mesh.mesh_dim_names.index(axis)) == 1:
        return params
    synced = _MeanOverTP.apply(mesh, axis, *(params[k] for k in names))
    return {**params, **dict(zip(names, synced))}


# ---------------------------------------------------------------------------
# the tensor-parallel transformer
# ---------------------------------------------------------------------------


class TPMultiHeadAttention(nn.Module):
    """The rank's share of ``MultiHeadAttention``: its column chunk of the
    fused qkv kernel and its row chunk of the output kernel."""

    def __init__(self, embed_dim: int, num_heads: int, tp: int, axis: str,
                 attn_fn=None, causal: bool = True):
        super().__init__()
        self.num_heads, self.tp, self.axis = num_heads, tp, axis
        self.attn_fn, self.causal = attn_fn, causal
        self.Dense_0 = Dense(embed_dim, 3 * embed_dim // tp, use_bias=False)
        self.Dense_1 = Dense(embed_dim // tp, embed_dim, use_bias=False)

    def forward(self, x):
        B, L, E = x.shape
        H, tp = self.num_heads, self.tp
        D, r = E // H, axis_index(self.axis)
        x = replicated_in(x, self.axis)
        # the whole [E, 3E] kernel: [q heads | k heads | v heads], head-major
        w = all_gather(self.Dense_0.kernel.to(x.dtype), self.axis, axis=1)
        attn = self.attn_fn or _default_attn
        if H % tp == 0:
            h = H // tp  # this rank's heads: its row chunk of the output kernel
            w = w.view(E, 3, H, D)[:, :, r * h:(r + 1) * h].reshape(E, 3 * h * D)
            q, k, v = (x @ w).view(B, L, 3, h, D).unbind(2)
            out = attn(q, k, v, self.causal).reshape(B, L, h * D)
        else:  # every head on every rank; the rank keeps its row chunk
            q, k, v = (x @ w).view(B, L, 3, H, D).unbind(2)
            out = attn(q, k, v, self.causal).reshape(B, L, E)
            out = out[..., r * (E // tp):(r + 1) * (E // tp)]
        return replicated_out(out @ self.Dense_1.kernel.to(out.dtype), self.axis)


class TPBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, tp: int, axis: str,
                 mlp_ratio: int = 4, attn_fn=None):
        super().__init__()
        self.axis = axis
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.MultiHeadAttention_0 = TPMultiHeadAttention(embed_dim, num_heads, tp, axis,
                                                         attn_fn)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.Dense_0 = Dense(embed_dim, mlp_ratio * embed_dim // tp)
        self.Dense_1 = Dense(mlp_ratio * embed_dim // tp, embed_dim)

    def forward(self, x):
        x = x + self.MultiHeadAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(replicated_in(self.LayerNorm_1(x), self.axis)),
                   approximate="tanh")
        down = replicated_out(h @ self.Dense_1.kernel.to(h.dtype), self.axis)
        return x + (down + self.Dense_1.bias.to(h.dtype))


class TPTransformerLM(TransformerLM):
    """``TransformerLM`` with every block tensor-parallel over ``axis``:
    valid only inside a bound mesh whose ``axis`` has ``tp`` ranks."""

    def __init__(self, vocab_size: int, embed_dim: int, num_heads: int, num_layers: int,
                 max_len: int, tp: int, axis: str, attn_fn=None, remat: bool = False,
                 pos_offset_fn=None):
        super().__init__(vocab_size, embed_dim, num_heads, num_layers, max_len,
                         attn_fn=attn_fn, remat=remat, pos_offset_fn=pos_offset_fn)
        # the plain blocks' placeholders carry the whole shapes
        whole = {"params": dict(self.named_parameters())}
        check_divisible(whole, tp_param_spec(whole, axis), {axis: tp})
        for name in self.blocks:
            setattr(self, name, TPBlock(embed_dim, num_heads, tp, axis, attn_fn=attn_fn))


@dataclasses.dataclass
class TPBundle(ModelBundle):
    """A bundle of ``TPTransformerLM``: its variables are the rank's
    blocks, laid out from the full model's (``shard_tp_params``).  Its
    replicated parameters' gradients are averaged over ``axis``
    (``mean_grads_over``)."""

    axis: str = "tp"
    replicated: Tuple[str, ...] = ()

    def _call(self, variables, x, train, updates, rng=None):
        params = mean_grads_over(variables["params"], self.replicated, self.axis)
        return super()._call({**variables, "params": params}, x, train, updates, rng)

    def init(self, key):
        raise TypeError("a tensor-parallel bundle holds slices: initialise the full "
                        "model with the plain transformer_lm bundle and lay it out "
                        "(shard_tp_params)")


def tp_bundle(plain: ModelBundle, tp: int, axis: str, device: DeviceLike = None) -> TPBundle:
    """The tensor-parallel counterpart of a plain ``transformer_lm`` bundle:
    the same dimensions, attention, remat and positions."""
    module = plain.module
    if not isinstance(module, TransformerLM) or not module.blocks:
        raise ValueError("tensor parallelism shards the transformer LM "
                         f"(models/transformer.py); got {type(module).__name__}")
    block = getattr(module, module.blocks[0])
    if not isinstance(block, Block):
        raise ValueError(f"{type(block).__name__} is already tensor-parallel")
    mha = block.MultiHeadAttention_0
    vocab, embed = module.wte.embedding.shape
    specs = tp_param_spec({"params": dict(module.named_parameters())}, axis)["params"]
    return TPBundle(
        module=TPTransformerLM(vocab, embed, mha.num_heads, len(module.blocks),
                               module.max_len, tp, axis, attn_fn=mha.attn_fn,
                               remat=module.remat, pos_offset_fn=module.pos_offset_fn),
        input_shape=plain.input_shape, device=plain.device if device is None else
        torch.device(device), input_dtype=plain.input_dtype, axis=axis,
        replicated=tuple(k for k, spec in specs.items() if not is_sharded(spec)))


@contextlib.contextmanager
def bind_tp(mesh, axis: str, specs: PyTree):
    """The context every TP computation runs in: ``mesh`` bound for the
    collectives, and the whole-model norms (``core/tree.py::global_sq_norm``)
    summing the sharded leaves' squares over ``axis``."""
    # at one rank every block is its whole leaf, and the norms stay tree_sq_norm's
    names = sharded_param_names(specs) if axis_sizes(mesh)[axis] > 1 else []
    with use_mesh(mesh), treelib.sharded_leaves(names, lambda t: replicated_out(t, axis)):
        yield


def tensor_parallel_lm(
    mesh,
    *,
    vocab_size: int = 256,
    embed_dim: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    seq_len: int = 256,
    axis: str = "tp",
):
    """Build ``(bundle, shard_params, apply, train_step)`` over ``mesh``.

    ``bundle`` is the plain ``transformer_lm`` on this rank's device: its
    ``init`` draws the full variables (JAX's for the same key).
    ``shard_params(variables)`` lays them out (this rank's ``Shard``s);
    ``apply(variables, tokens)`` is the forward on every rank (logits
    replicated); ``train_step(variables, tokens, targets, lr)`` one SGD step
    on the causal-LM loss, whose updated variables keep the layout.  Every
    rank of ``mesh`` calls each with the same tokens."""
    device = mesh_device(mesh)
    bundle = transformer_lm(vocab_size=vocab_size, embed_dim=embed_dim,
                            num_heads=num_heads, num_layers=num_layers,
                            seq_len=seq_len, device=device)
    tp = tp_bundle(bundle, axis_sizes(mesh)[axis], axis)

    def shard_params(variables: PyTree) -> PyTree:
        return shard_tp_params(mesh, variables, axis)

    def _tokens(t):
        return torch.as_tensor(t).to(device)

    @torch.no_grad()
    def apply(variables, tokens):
        with use_mesh(mesh):
            return tp.apply_eval(blocks(variables), _tokens(tokens))

    def train_step(variables, tokens, targets, lr):
        vs = blocks(variables)
        params = {k: v.detach().requires_grad_(True) for k, v in vs["params"].items()}
        with bind_tp(mesh, axis, tp_param_spec(vs, axis)), torch.enable_grad():
            logits = tp.apply_eval({**vs, "params": params}, _tokens(tokens))
            logp = F.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(-1, _tokens(targets).long()[..., None])[..., 0]
            loss = nll.mean()
            grads = torch.autograd.grad(loss, list(params.values()))
        new = {k: (p - lr * g.to(p.dtype)).detach()
               for (k, p), g in zip(params.items(), grads)}
        return rewrap({**vs, "params": new}, variables), loss.detach()

    return bundle, shard_params, apply, train_step
