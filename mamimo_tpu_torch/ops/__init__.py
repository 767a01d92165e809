"""Signal-processing ops: LTF/P preamble and the LS estimator."""
