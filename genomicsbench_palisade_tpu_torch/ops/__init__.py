"""Device operations: the PairHMM forward pass and the banded Smith-Waterman
extension, their kernel wrappers and the oracles they are held to."""
