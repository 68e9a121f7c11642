"""Host-side I/O: the phmm test-file, bsw pair-file and chain anchor-dump
parsers, length bucketing, FASTA/FASTQ reads, and abea's raw signals and
pore model."""
