"""Shared utilities: kernel build and profiling."""
