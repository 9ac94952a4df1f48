"""Multiple devices (ports livetalking_tpu/parallel/).

The JAX package places arrays on a device mesh and lets XLA insert the
collectives. Here every device has its own process (a rank), and the
collectives are explicit ``torch.distributed`` calls:

  - ``dist`` starts or joins the ranks (one per device: NCCL on CUDA,
    gloo on the CPU) and holds the collectives;
  - ``mesh`` builds the dp x tp mesh over them and the sharding rule:
    batches are cut over ``dp``, the large convs' output channels over
    ``tp``;
  - ``tp`` is the conv seam: a conv whose parameters ``shard_params``
    sharded computes its slice of output channels and gathers the rest
    over the tp group, so activations between layers are whole;
  - ``dryrun`` is the multi-device dry run
    (``python -m livetalking_tpu_torch.parallel.dryrun N``).
"""
