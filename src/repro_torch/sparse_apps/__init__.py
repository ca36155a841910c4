"""Applications built on the batched SpGEMM: ``mcl`` (HipMCL-style Markov
clustering, paper §V-C)."""
