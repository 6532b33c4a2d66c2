from repro_torch.sharding.specs import (  # noqa: F401
    Mesh, PartitionSpec, ShardingRules, abstract_mesh, batch_specs,
    cache_specs, constrain, named, param_specs, sharding_context)
