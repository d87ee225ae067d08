"""The port of ``paddle_tpu/core/compat.py``: what its callers read.

The reference writes its manual-axes parallel stack (the compiled
pipelines, manual tp, the collective matmuls) against jax's ``shard_map``
and its varying-manual-axes types, and ``HAS_MANUAL_AXES`` says whether the
installed jax has them. The port runs one program a rank over
``torch.distributed``: every rank already runs its own program with explicit
collectives, which is what a manual axis is, so the capability is always
there. There is no ``shard_map`` to emulate: a function of the local
shards is what each rank runs anyway.
"""

#: every rank runs its own program with explicit collectives
HAS_MANUAL_AXES: bool = True
