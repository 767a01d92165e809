"""Channel-sounding pipeline (so far only ``sounding.pad_signal``; the
rest of ``mamimo_tpu/pipeline`` waits for the data-generation slice)."""
