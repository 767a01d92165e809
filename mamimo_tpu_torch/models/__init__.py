"""The CSI denoiser MLP (eval and training mode) and, in ``models.predictor``, the
deployment wrapper ``CSIPredictor``."""

from mamimo_tpu_torch.models.mlp import (  # noqa: F401
    csi_mlp_apply,
    init_csi_mlp,
    init_stacked,
    model_input_spec,
    params_from_jax,
    predict_complex,
    stacked_apply,
)
