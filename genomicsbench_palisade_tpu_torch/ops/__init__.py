"""Device operations: the PairHMM forward pass, its kernel wrappers and
the oracle they are held to."""
