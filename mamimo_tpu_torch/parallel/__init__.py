"""Sharded forms over a mesh of torch devices (the port's counterpart of
``mamimo_tpu/parallel``): ``mesh`` (``Mesh``, ``make_mesh``),
``multihost`` (joining processes into one ``torch.distributed`` group),
``collectives`` (the sums across ranks and processes), ``halo`` (the FIR
channel taps and the sequence-parallel overlap-save convolution),
``rdma_halo`` (the same with the halo exchange as a CUDA peer-put
kernel) and ``sharded`` (the sharded LS and DNN inference forms, and the
DP+TP training step)."""
