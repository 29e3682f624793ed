"""``repro_torch.training`` — training on one device (the counterpart of
``repro.training``): AdamW and its schedules (:mod:`.optimizer`), the
microbatched train step (:mod:`.loop`), atomic checkpoints in the
reference's on-disk format (:mod:`.checkpoint`) and supervised restart
(:mod:`.fault_tolerance`).  Trees are nested dicts of tensors
(:mod:`.tree`), laid out as the reference's parameter trees."""
