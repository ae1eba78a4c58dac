"""Experiment configs: the dataclasses and ``load_config`` in
:mod:`.base`, one file per experiment beside it."""
