"""Host-side I/O: the phmm test-file and bsw pair-file parsers and length
bucketing."""
