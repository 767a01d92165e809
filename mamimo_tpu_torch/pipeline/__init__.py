"""The pipeline (the port's copy of ``mamimo_tpu/pipeline``): ``sounding``
(a batch of packets from their draws), ``dataset`` (``generate_dataset``,
``CSIDataset``), ``datatx`` (the closed loop's coded data leg) and
``multiuser`` (per-user scenarios and sounding)."""
