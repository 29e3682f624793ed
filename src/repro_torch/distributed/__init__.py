"""``repro_torch.distributed`` — partitioned retrieval (the counterpart of
``repro.distributed``).  Only the local top-k merge is ported
(:mod:`repro_torch.distributed.topk`); sharding, the collective merge and
the reductions belong to the multi-GPU slice."""
