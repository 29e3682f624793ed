"""``repro_torch.distributed`` — partitioned retrieval and training's
collectives (the counterpart of ``repro.distributed``): THE top-k merge,
local and collective (:mod:`repro_torch.distributed.topk`), the build's
deterministic cross-device sums (:mod:`repro_torch.distributed.reduce`),
int8 gradient compression with error feedback and the int8
all-reduce-mean ``compressed_psum``
(:mod:`repro_torch.distributed.compression`), and the logical-axis
sharding rules of data-parallel training
(:mod:`repro_torch.distributed.sharding`)."""
