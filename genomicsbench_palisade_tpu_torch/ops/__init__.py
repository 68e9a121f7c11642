"""Device operations: the PairHMM forward pass, the banded Smith-Waterman
extension, the anchor-chaining DP, the adaptive banded event alignment
(with its host event detection and the eventalign realign), the FM-index
search, the k-mer counter, the POA aligner and the GRM, their kernel
wrappers and the oracles they are held to."""
