"""NumPy scalar oracles: the semantic ground truth the port is held to."""
