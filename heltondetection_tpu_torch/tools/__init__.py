"""The port's user tools, each runnable as ``python -m
heltondetection_tpu_torch.tools.<name>``; counterparts of the JAX
package's ``tools/`` scripts of the same names.

* ``autoanchor``: the best possible recall of a config's anchors on its
  train split, and anchors fitted to it as a ``model.anchors`` tuple.
* ``eval_ultralytics_weights``: an Ultralytics YOLOv5 ``.pt`` scored
  through the port's eval, in float or in W8A8 int8 (``--int8``).

Each module's ``main(argv=None)`` returns what it printed or scored, so
that a program can call it in-process.
"""
