"""Channel-sounding pipeline (the port's copy of ``mamimo_tpu/pipeline``,
single user): ``sounding`` (a batch of packets from their draws) and
``dataset`` (``generate_dataset``, ``CSIDataset``)."""
