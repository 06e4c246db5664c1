"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu, batched etcd-raft over
[groups x voters] tensors on an NVIDIA H100.

The JAX package `raft_tpu` is the reference: on the same seed and Shape,
this package walks the same trajectory leaf for leaf (interop.py carries
state across). Entry points run on `cuda` unless the caller passes
`device="cpu"`; each TPU kernel of the path has a hand-written CUDA
counterpart under csrc/ (ops/quorum_cuda.py). This package never imports
JAX or `raft_tpu`.

Main path: scheduler.BlockedFusedCluster -> ops.fused.FusedCluster.run ->
ops.fused.fused_rounds (route_fabric + fused_round per round).
"""
