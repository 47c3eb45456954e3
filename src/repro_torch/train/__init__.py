"""Training: optimizers, the train step with f32 master weights, the
loop with checkpoint/restart and local SGD, int8 delta compression.

The submodules are not imported here: ``models/convert.py`` imports
``train/tree.py``, and ``train/step.py`` imports the models."""
