"""Scale-out: the serving mesh, its sharding rules and collectives, the
ring, the process group, and batch re-scoring.

Counterpart of ``llm_weighted_consensus_tpu/parallel``, with one process
driving a mesh of local devices:

* ``mesh``: the named (dp, tp[, sp]) grid of torch devices;
* ``sharding``: the reference's partition-rule tables over the port's
  tensors, a model placed per tp shard on each device;
* ``collectives``: all_gather / psum / pmax / ppermute as explicit
  cross-device work, the shards' lockstep runner, the sharded consensus
  vote and tally;
* ``ring``: sequence parallelism over ``sp`` (ring attention);
* ``dist``: the ``torch.distributed`` group across processes (dp only);
* ``batch``: archive re-scoring over the mesh (BASELINE config 4);
* ``multihost_smoke``: the multi-process proof.

The reference's ``compat`` (a ``shard_map`` spelling shim) has no
counterpart.  No pipeline and no expert parallelism, by design, as in the
reference.
"""

from .dist import maybe_initialize_distributed  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from . import batch, collectives, ring, sharding  # noqa: F401
