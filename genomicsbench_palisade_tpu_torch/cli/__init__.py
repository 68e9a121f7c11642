"""CLI drivers reproducing the reference benchmark binaries' flags and
printed outputs."""
