"""Applications built on the batched SpGEMM: ``mcl`` (HipMCL-style Markov
clustering, paper §V-C) and ``graph_algorithms`` (triangle counting and
overlap pairs, paper §V-B; all-pairs shortest paths over min-plus)."""
