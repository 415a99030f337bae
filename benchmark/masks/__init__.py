"""Sparsity masks, one module per name a configuration's ``mask.kind``
gives: ``make(partitions [P, K] complex, config) -> bool [P, K]`` (True:
the bin is kept)."""
