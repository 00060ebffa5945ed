from repro_torch.parallel.sharding import (LP, NO_MESH, ParallelCtx,
                                           logical_to_physical, make_ctx,
                                           shard_map, tree_shardings)

__all__ = ["LP", "NO_MESH", "ParallelCtx", "logical_to_physical",
           "make_ctx", "shard_map", "tree_shardings"]
