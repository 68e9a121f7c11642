"""Host-side I/O: the phmm test-file parser and length bucketing."""
