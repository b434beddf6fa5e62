"""The GPT-2-shaped decoder: the program's ``TransformerLM`` (attention on
the hand-written flash kernel) and ``reference/transformer.py``."""

from __future__ import annotations

from benchmark import counts
from benchmark.reference import transformer as ref

variable_shapes = ref.variable_shapes
COUNT_UNIT = "tokens"


def init_rule(name, shape):
    """GPT-2's: normal with std 0.02 for kernels and embeddings; LayerNorm
    scales one; biases zero."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("kernel", "embedding"):
        return ("normal", 0.02)
    if leaf == "scale":
        return ("ones",)
    return ("zeros",)


def program_bundle(cfg, traffic, device):
    from fedml_tpu_torch.models.transformer import transformer_lm

    return transformer_lm(vocab_size=cfg["vocab_size"], embed_dim=cfg["n_embd"],
                          num_heads=cfg["n_head"], num_layers=cfg["n_layer"],
                          seq_len=traffic["seq_len"], max_len=cfg["n_positions"],
                          device=device)


def reference_model(cfg, traffic, rounding=None):
    return ref.Transformer(cfg, rounding)


def train_flops_per_unit(cfg, traffic) -> float:
    """Model FLOPs of one real token's step: 3× the forward."""
    return 3.0 * ref.forward_flops_per_token(cfg, traffic["seq_len"])


def kernel_bounds(cfg, traffic):
    """The flash kernel's least time per computed step: one causal forward
    per layer over the step's ``[batch, L, heads, D]``."""
    d = cfg["n_embd"] // cfg["n_head"]
    one = max(counts.flash_bound_ms(traffic["batch_size"], traffic["seq_len"],
                                    traffic["seq_len"], cfg["n_head"], d,
                                    cfg["compute_dtype"], True))
    return {"flash": {"names": ("flash_fwd",), "launch_names": ("flash_fwd",),
                      "launches_per_step": cfg["n_layer"],
                      "bound_ms_per_step": cfg["n_layer"] * one}}
