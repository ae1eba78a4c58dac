"""Data parallelism over processes and cards (``mesh.py``) and the
multi-rank dry run (``dryrun.py``); counterpart of
heltondetection_tpu/parallel/. The reference's spatial sharding
(``parallel/spatial.py``) is not ported yet (ROADMAP A14b)."""
