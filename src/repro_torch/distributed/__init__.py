"""``repro_torch.distributed`` — partitioned retrieval and training's
gradient compression (the counterpart of ``repro.distributed``): THE
top-k merge, local and collective (:mod:`repro_torch.distributed.topk`),
the build's deterministic cross-device sums
(:mod:`repro_torch.distributed.reduce`) and int8 gradient compression with
error feedback (:mod:`repro_torch.distributed.compression`).  The
reference's ``sharding`` (logical-axis rules) and ``compressed_psum``
serve data-parallel training, which is not ported (ROADMAP Queue 1 item
8)."""
