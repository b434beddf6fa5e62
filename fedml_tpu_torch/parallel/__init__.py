"""Multi-device execution of the port over ``torch.distributed``
(counterpart of ``fedml_tpu/parallel``).

JAX runs one program on N devices in one process (``shard_map`` with
``lax.psum``/``ppermute``/``all_gather``/``axis_index``).  The port runs
one process per mesh position, each the same Python, with collectives
over the named dimensions of a ``DeviceMesh``: gloo across CPU processes,
NCCL on the card.

- ``compat.py`` — the collective surface every engine imports (``psum``,
  ``axis_index``, ``axis_size``, ``ppermute``, ``all_gather``,
  ``all_to_all``, the ``shard_map`` counterpart that binds a mesh) and
  ``launch``, which brings a mesh's ranks into being.
- ``mesh.py`` — the ``--mesh dp,mp`` parser and the dp×mp mesh.
- ``spmd.py`` — FedAvg over a ``clients`` mesh axis, its host-local data
  assembly, and the two-tier round on a ``(group, clients)`` mesh.
- ``ring_attention.py`` — blockwise attention and the K/V rings (the
  blockwise ring and the flash ring) over a sequence-sharded axis.
- ``sequence.py`` — the sequence-parallel transformer LM.
- ``dp_sp.py`` — FedAvg rounds on a ``(clients, sp)`` mesh.
- ``layout.py`` — sharded leaves (``Shard``: a rank's block of a leaf laid
  out by a spec), their slices and gathers.
- ``tensor.py`` — the Megatron tensor-parallel transformer.
- ``gspmd.py`` — FedAvg rounds on a ``(clients, model)`` mesh with the
  tensor-parallel transformer.
- ``partition.py`` — the partition-rule tables and the rule engine's round
  on a ``(dp, mp)`` mesh.
- ``pipeline.py`` — the GPipe microbatch pipeline over a ``pp`` axis.
- ``expert.py`` — the top-1 mixture-of-experts FFN over an ``ep`` axis,
  its tokens routed by ``compat.all_to_all``.
- ``dryrun.py`` — ``dryrun_multichip``, the multi-device check, and the
  rank bodies of the CPU parity tests.

The muxed cohort on a mesh (ROADMAP.md, queue A item 6c-2) is not ported
yet.
"""
