"""Batched FASTQ/FASTA input and ordered output (host)."""
