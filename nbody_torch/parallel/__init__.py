"""The multi-device layouts (the port of nbody_tpu.parallel): one
process a rank under torch.distributed, started by launch.spawn; mesh holds
a rank's view of the group and the collectives; ring the all-pairs ring;
tree_sharded the replicated trees with row-sharded evaluation; dryrun the
counterpart of nbody_tpu's dryrun_multichip. nbody_tpu's partitioned
layout (tree_partitioned.py, distributed_sort.py, body_tile_mesh) is not
yet ported."""
