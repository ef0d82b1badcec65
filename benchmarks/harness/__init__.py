"""The benchmark of `tpu_device_plugin_torch`: the yardstick the port is held to.

Nothing here imports JAX or the JAX package. `reference.py`, the plain
PyTorch model of the port's block that decides `correct`, imports nothing
of the port either, nor does a configuration's own definition (block.py);
`program.py` is the only module that calls into it.
"""
