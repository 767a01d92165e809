"""Sharded forms over a mesh of torch devices (the port's counterpart of
``mamimo_tpu/parallel``): ``mesh`` (``Mesh``, ``make_mesh``), ``halo``
(the FIR channel taps and the sequence-parallel overlap-save
convolution), ``rdma_halo`` (the same with the halo exchange as a CUDA
peer-put kernel) and ``sharded`` (the sharded LS and DNN inference
forms). The DP+TP training step and ``multihost`` wait for the training
slice."""
