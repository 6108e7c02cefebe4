from tgi_torch.parallel.mesh import (Mesh, constrain_ray_axis, data_sharding,
                                     init_from_env, make_mesh,
                                     ray_constrained, ray_sharding, replicate,
                                     shard_batch)
