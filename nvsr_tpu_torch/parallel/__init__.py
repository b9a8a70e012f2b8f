from nvsr_tpu_torch.parallel.sharding import (  # noqa: F401
    data_sharding,
    decoder_tp_shardings,
    gather_tree,
    make_mesh,
    plane_sr_tp_shardings,
    replicate,
    shard_rays,
    shard_tree,
)
