"""The benchmark of `tpu_device_plugin_torch`: the yardstick the port is held to.

Nothing here imports JAX or the JAX package. `reference.py`, the plain
PyTorch model that decides `correct`, imports nothing of the port either;
`program.py` is the only module that calls into it.
"""
