"""Tensor parallelism over `torch.distributed`: which shard of each
parameter and cache a rank holds (`sharding`) and the explicit-collective
layers (`tp`). Meshes and rank processes are `launch.mesh`'s."""
