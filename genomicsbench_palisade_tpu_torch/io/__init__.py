"""Host-side I/O: the phmm test-file, bsw pair-file and chain anchor-dump
parsers, and length bucketing."""
