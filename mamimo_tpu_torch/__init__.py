"""mamimo_tpu_torch — the PyTorch/CUDA port of ``mamimo_tpu`` for NVIDIA
Hopper (H100).

A second package beside the JAX one, which stays the reference. Plain
tensor code is PyTorch; each TPU kernel on the ported path is a CUDA C++
kernel written by hand for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use into ``_build/`` and bound through ``ctypes``.

- ``config``            : SimConfig / TrainConfig (same fields and JSON),
                          ``default_fft_size``
- ``ops.ltf``           : LTF sequence, Hadamard P, sounding preamble
- ``ops.ofdm``          : OFDM grid, modulation and demodulation
- ``ops.estimate``      : the LS estimate in its FFT, time-major,
                          rx-major and flat-planes forms (plain
                          versions), and the five LMMSE forms
- ``ops.kernels``       : kernel wrappers (LS v2, v1 and per pair, fused
                          factored DNN, fused MLP on the materialized
                          input, int8 GEMM); the halo-exchange kernel's
                          wrapper is in ``parallel.rdma_halo``
- ``models``            : the CSI MLP (eval and train mode), its int8
                          quantized form
                          (``models.quant``) and ``CSIPredictor``
- ``bench``             : the TPU bench's estimation paths,
                          ``run_bench`` (``python3 -m
                          mamimo_tpu_torch.bench``),
                          ``run_train_bench`` (``... --train``) and
                          ``run_gen_bench`` (``... --gen``)
- ``entry``             : the serving step of ``__graft_entry__.py``
- ``train.ckpt``        : npz checkpoints with the optimizer state,
                          interchangeable with the JAX package's
- ``train.loop``        : the training step in array form (Adam
                          scaling, the AWGN batch update, the in-gather
                          step and its multi-step form), ``fit`` in its
                          three single-card modes and
                          ``evaluate_dataset``
- ``data``              : the raw container and its native C++ loader,
                          the reference's MATLAB and pickle formats, the
                          datasource registry
- ``eval``, ``ops.metrics`` : NMSE/MSE/EVM/BER, ``nmse_vs_snr``, plots
- ``cli``               : ``python3 -m mamimo_tpu_torch.cli gen|train|
                          test|convert|bench``
- ``channel``           : the single-bounce scattering channel, the CDL
                          channel and the receiver noise chains
- ``pipeline``          : the sounding of a batch of packets
                          (``sounding``) and single-user dataset
                          generation (``dataset``)
- ``parallel``          : meshes of torch devices, the sequence-parallel
                          channel convolution with its halo-exchange
                          kernel, the sharded LS and DNN inference forms
- ``utils.numerics``    : ``unit_phasor``, the precision of products,
                          device-to-host copies; ``utils.profiling``:
                          traces and inference timing
"""

__version__ = "0.1.0"

from mamimo_tpu_torch.config import SimConfig, TrainConfig  # noqa: F401
