"""Device operations: the PairHMM forward pass, the banded Smith-Waterman
extension and the anchor-chaining DP, their kernel wrappers and the oracles
they are held to."""
