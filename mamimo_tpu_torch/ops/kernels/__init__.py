"""Wrappers of the hand-written CUDA kernels (counterpart of
``mamimo_tpu/ops/pallas``). Each wrapper launches its kernel on CUDA
tensors and runs the kernel's plain version on CPU tensors; each keeps a
``launches`` count of kernel launches."""

from mamimo_tpu_torch.ops.kernels.fused_factored import (  # noqa: F401
    factored_sig_proj,
    factored_tail,
    fused_factored_planes,
    predict_all_pairs_planes_kernel,
    prepare_factored_weights,
)
from mamimo_tpu_torch.ops.kernels.fused_ls import (  # noqa: F401
    LsSm90Constants,
    ls_estimate_pallas,
    ls_kernel_constants,
    ls_planes_pallas,
    ls_planes_pallas_constants,
    ls_planes_pallas_v2_constants,
    ls_planes_v1,
    ls_planes_v2,
    ls_raw_to_complex,
    ls_sm90_constants,
    ls_sm90_row_order,
    ls_v2_to_complex,
    tf32_split,
)
from mamimo_tpu_torch.ops.kernels.int8_mm import (  # noqa: F401
    matmul_float,
    matmul_int8,
    matmul_pallas,
)
from mamimo_tpu_torch.ops.kernels.mlp_infer import (  # noqa: F401
    fold_bn_into_dense,
    mlp_infer_layer1,
    mlp_infer_pallas,
    mlp_infer_tail,
    predict_complex_pallas,
    prepare_mlp_infer_weights,
)
