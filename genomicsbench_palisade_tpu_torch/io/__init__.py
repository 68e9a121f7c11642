"""Host-side I/O: the phmm test-file, bsw pair-file and chain anchor-dump
parsers, length bucketing, FASTA/FASTQ reads, abea's raw signals and
pore model, the BAM reader, plink's genotype files and flax's msgpack
weights."""
