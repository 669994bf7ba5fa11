"""Row-partitioned multi-device training on torch.distributed, one process
per device: the mesh, the row collectives, the sharded graph and the
sharded train and eval steps."""
