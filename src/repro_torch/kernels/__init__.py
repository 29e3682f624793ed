"""Hand-written Hopper kernels of the PLAID search path and their plain
PyTorch versions.

=====================  ==============================  ===================
wrapper                CUDA source (csrc/)             replaces (repro)
=====================  ==============================  ===================
``maxsim``             ``maxsim.cu`` (K1, K5)          ``kernels/maxsim.py``
``decompress``         ``decompress.cu`` (K2, K6, K4)  ``kernels/decompress.py``
``fused_score``        ``fused_score.cu`` (K3)         ``kernels/fused_score.py``
``flash_attention``    ``flash_attention.cu`` (K7)     ``kernels/flash_attention.py``
=====================  ==============================  ===================

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``ref``) for CPU tensors only; there is no other switch.  A third branch
is taken only for ``meta`` tensors (the dry-run, ``launch.dryrun``): it
computes nothing, returns an empty meta tensor of the plain version's
shape and dtype and charges its kernel's ``costs`` model to the active
``launch.meta_cost`` counter.  Each counts its launches in a module-level
integer (``launches``; K5 and K6, the B=1 launches of K1 and K2, in
``single_launches``; K4 in ``residual_launches``); ``ops.launch_counts()``
reads them all; a meta call counts none.

``costs`` holds each kernel's cost model (``KERNEL_COSTS``: the
reference's flops, the Hopper kernel's compulsory bytes, which
``chip_smoke.py``'s bounds use) and the tiered index's host-to-device
transfer model (``tiered_transfer_cost``), which the tiered engine's
counts must equal.
"""
