"""Device operations: the PairHMM forward pass, the banded Smith-Waterman
extension, the anchor-chaining DP and the adaptive banded event alignment
(with its host event detection), their kernel wrappers and the oracles
they are held to."""
