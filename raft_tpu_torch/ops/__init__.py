"""Round ops: the fused round and the batched raft primitives under it."""
