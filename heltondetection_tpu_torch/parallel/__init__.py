"""Data parallelism over processes and cards (``mesh.py``), spatial
sharding of the image's H axis over ranks (``spatial.py``) and the
multi-rank dry run (``dryrun.py``); counterpart of
heltondetection_tpu/parallel/."""
