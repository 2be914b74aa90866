"""The multi-device layouts (the port of nbody_tpu.parallel): one
process a rank under torch.distributed, started by launch.spawn; mesh holds
a rank's view of the group, the 2-D body x tile mesh and the collectives;
ring the all-pairs ring; tree_sharded the replicated trees with row-sharded
evaluation; distributed_sort and tree_partitioned the partitioned trees;
dryrun the counterpart of nbody_tpu's dryrun_multichip."""
