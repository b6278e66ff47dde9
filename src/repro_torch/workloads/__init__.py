"""Paper workloads: mmap-bench (§III.A) and the DLRM embedding trace (§III.B)."""
