"""DLRM embedding-table tiering — the paper's §III.B evaluation workload."""
