"""Several devices for one job: the sample-sharded GRM of the null fit and
the variant-sharded scan (``mesh.py``), and the variant-range shards of a
scan run as separate processes or cluster jobs (``distributed.py``)."""
