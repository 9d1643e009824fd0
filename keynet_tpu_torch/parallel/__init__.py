from .sharding import (Mesh, batch_mesh, shard_batch, keyed_forward_sharded,
                       replicate_ops, shard_keynet_ops, keyed_forward_dp_tp)
from .launch import launch, init_rank
