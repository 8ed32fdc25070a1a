"""Batched device work across requests: the port's counterpart of
``llm_weighted_consensus_tpu/parallel``, single-device (the mesh, the
sharding rules and the collectives wait for their own slice)."""
