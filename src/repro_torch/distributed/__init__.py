"""``repro_torch.distributed`` — partitioned retrieval (the counterpart of
``repro.distributed``): THE top-k merge, local and collective
(:mod:`repro_torch.distributed.topk`), and the build's deterministic
cross-device sums (:mod:`repro_torch.distributed.reduce`).  The reference's
``sharding`` (logical-axis rules) and ``compression`` (int8 gradients)
serve only its training loop and come with the training slice."""
