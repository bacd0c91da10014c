"""The cells' traffic cut to sizes a CPU test run holds."""

SMALL = {
    "hosp_readmit": {"rows": 40000, "chunk_rows": 10000,
                     "slack_rows": 8192, "granule_rows": 256, "block": 8192},
    "elearn_knn": {"refs": 20000, "batch": 512, "pool_rows": 4096,
                   "check_batches": 2},
}
