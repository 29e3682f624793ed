"""``repro_torch.training`` — training on one device or data-parallel over
a process group (the counterpart of ``repro.training``): AdamW and its
schedules (:mod:`.optimizer`), the microbatched train step, the global
batch's step on a data mesh (:mod:`.loop`), atomic checkpoints in the
reference's on-disk format that restore at any world size
(:mod:`.checkpoint`), and supervised restart and re-mesh
(:mod:`.fault_tolerance`).  Trees are nested dicts of tensors
(:mod:`.tree`), laid out as the reference's parameter trees."""
