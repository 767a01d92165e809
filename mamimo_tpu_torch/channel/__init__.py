"""Channel models (the port's copy of ``mamimo_tpu/channel``): the
single-bounce scattering channel (``scattering``), the clustered delay
line (``cdl``) and the receiver noise chains (``noise``)."""
