"""Dataset containers and reference-format interop: the raw container and
its native C++ loader (``native_loader``), the reference's MATLAB and
pickle formats (``matlab_io``) and the datasource registry
(``sources``)."""

from mamimo_tpu_torch.data.matlab_io import (  # noqa: F401
    export_predictions_mat,
    load_pickle_dataset,
    load_reference_mat,
    save_pickle_dataset,
)
from mamimo_tpu_torch.data.sources import get_datasource, register_datasource  # noqa: F401
