"""Channel models (the port's copy of ``mamimo_tpu/channel``): so far the
single-bounce scattering channel, ``channel.scattering``. The CDL model
and the receiver noise chains wait for the data-generation slice."""
