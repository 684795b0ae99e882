"""PyTorch/CUDA port of the CG stream partitioner (``repro`` is the JAX
reference).

Mirrors ``repro``'s module names, function names and argument order so
one test can call both packages. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; the two routing kernels of
the CG pipeline (``kernels.porc_snapshot``) are hand-written CUDA C++
for Hopper (``kernels/csrc/porc_snapshot.cu``), built at first use.
"""
