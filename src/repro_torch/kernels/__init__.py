"""Hand-written Hopper kernels of the PLAID search path and their plain
PyTorch versions.

=====================  ==============================  ===================
wrapper                CUDA source (csrc/)             replaces (repro)
=====================  ==============================  ===================
``maxsim``             ``maxsim.cu``                   ``kernels/maxsim.py``
``decompress``         ``decompress.cu``               ``kernels/decompress.py``
``fused_score``        ``fused_score.cu``              ``kernels/fused_score.py``
=====================  ==============================  ===================

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``ref``) for CPU tensors only; there is no other switch.  Each counts its
launches in a module-level integer ``launches``.
"""
